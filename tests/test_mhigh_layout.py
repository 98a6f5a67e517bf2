"""M-high physical layout: the Shor circuit with the work register in the
top physical bits (row-gather oracle, low-qubit iQFT).  Amplitudes must be
the standard-layout amplitudes under the bit permutation, and the driver
must produce identical measurement statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.shor import shors_algorithm
from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine
from tests.conftest import random_state


def physical_of_logical(idx: int, L: int, M: int) -> int:
    """Inverse of engine.logical_index: logical bit b<M -> physical L+b;
    logical bit b>=M -> physical b-M."""
    m_part = idx & ((1 << M) - 1)
    l_part = idx >> M
    return (m_part << L) | l_part


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (33, 7, 5, 6)])
def test_mhigh_circuit_amplitude_parity(C, a, L, M):
    n = L + M
    want = ref.shor_circuit(C, a, L, M)  # logical (standard) amplitudes
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
    got_phys = eng.to_numpy(eng.run(shor_circuit_mhigh(C, a, L, M)))
    # permute physical -> logical and compare
    got = np.empty_like(got_phys)
    for p in range(1 << n):
        got[eng.logical_index(p)] = got_phys[p]
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_camodc_high_matches_standard(rng):
    C, A, M = 21, 4, 5
    L = 4
    n = L + M
    psi = random_state(n, rng)  # treat as PHYSICAL m-high state
    got = np.asarray(xops.apply_camodc_high(jnp.asarray(psi), C, A, c_phys=2, M=M))
    # Build the logical-space equivalent: physical p = (m << L) | l_bits,
    # control physical bit 2 == logical qubit M+2.
    psi_logical = np.empty_like(psi)
    for p in range(1 << n):
        m_part = p >> L
        l_part = p & ((1 << L) - 1)
        psi_logical[m_part | (l_part << M)] = psi[p]
    want_logical = ref.apply_c_amodc(psi_logical, C, A, c_q=M + 2, M=M)
    want = np.empty_like(psi)
    for p in range(1 << n):
        m_part = p >> L
        l_part = p & ((1 << L) - 1)
        want[p] = want_logical[m_part | (l_part << M)]
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_mhigh_driver_end_to_end():
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128, layout="m_high")
    assert res.ok and res.factors == (5, 3)
    # Same seed, same measured LOGICAL index as the standard layout? The
    # physical probability ordering differs, so indices may differ — but the
    # omega statistics and factors must match.
    res_std = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128)
    assert res_std.factors == res.factors


def test_mhigh_omega_distribution():
    # The omega distribution must be identical to the standard layout's
    # (uniform over the period-4 harmonics for C=15, a=7).
    C, a, L, M = 15, 7, 3, 4
    from quantumcomputer.algorithms.shor import read_omega

    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
    state = eng.run(shor_circuit_mhigh(C, a, L, M))
    probs = np.asarray(eng.probabilities(state))
    omega_prob: dict[float, float] = {}
    for p, pr in enumerate(probs):
        if pr > 1e-15:
            w = read_omega(eng.logical_index(p), L, M)
            omega_prob[w] = omega_prob.get(w, 0.0) + float(pr)
    assert set(omega_prob) == {0.0, 0.25, 0.5, 0.75}
    for w, pr in omega_prob.items():
        assert abs(pr - 0.25) < 1e-12


def test_mhigh_pallas_backend(rng):
    # n=15 through the engine in the m-high layout.
    C, a, L, M = 33, 7, 9, 6
    want = ref.shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    got_phys = eng.to_numpy(eng.run(shor_circuit_mhigh(C, a, L, M)))
    got = np.empty_like(got_phys)
    idx = np.arange(1 << (L + M))
    logical = (idx >> L) | ((idx & ((1 << L) - 1)) << M)
    got[logical] = got_phys
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mhigh_on_mesh_factors():
    """m_high + mesh is supported since round 2 (sharded row-exchange
    oracle); the driver must factor correctly through it."""
    from quantumcomputer.parallel.mesh import build_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    res = shors_algorithm(
        C=15, L=3, M=4, forced_trial_int=7, seed=0,
        dtype=jnp.complex128, mesh=build_mesh(num_devices=2), layout="m_high",
    )
    assert res.ok and res.factors == (5, 3)


def _mhigh_oracle_reference(psi_phys, C, A, c_phys, L, M):
    """complex128 reference for camodc_high: map the physical m_high
    amplitudes to the standard layout, apply the reference gate with the
    control at logical bit M + c_phys, map back."""
    idx = np.arange(1 << (L + M))
    logical = (idx >> L) | ((idx & ((1 << L) - 1)) << M)
    psi_log = np.empty_like(psi_phys)
    psi_log[logical] = psi_phys
    out_log = ref.apply_c_amodc(psi_log, C, A, M + c_phys, M)
    return out_log[logical]


@pytest.mark.parametrize("c_phys", [0, 3, 6, 9, 10])
def test_mhigh_oracle_matches_reference(c_phys, rng):
    """apply_camodc_high (whole-row gather + control mask) vs the complex128
    reference at every control stride class."""
    C, A, M = 33, 29, 6
    L = 11
    n = L + M  # rest = 2048 columns, rows = 64
    psi = random_state(n, rng)
    got = np.asarray(xops.apply_camodc_high(jnp.asarray(psi, jnp.complex64), C, A, c_phys, M))
    want = _mhigh_oracle_reference(psi, C, A, c_phys, L, M)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mhigh_pallas_engine_uses_dma_oracle(rng):
    # Full m-high Shor through the engine (row-gather oracle in dispatch).
    C, a, L, M = 33, 7, 9, 6  # rows=64, rest=512
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

    want = ref.shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    got_phys = eng.to_numpy(eng.run(shor_circuit_mhigh(C, a, L, M)))
    idx = np.arange(1 << (L + M))
    logical = (idx >> L) | ((idx & ((1 << L) - 1)) << M)
    got = np.empty_like(got_phys)
    got[logical] = got_phys
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("c_phys,n_minus_m", [(13, 14), (13, 16), (14, 15), (15, 16)])
def test_mhigh_oracle_high_control(c_phys, n_minus_m, rng):
    """High control bits (stride >= 2^13): the control mask selects whole
    column blocks; parity vs the complex128 reference."""
    C, A, M = 33, 29, 6
    psi = random_state(n_minus_m + M, rng)
    got = np.asarray(xops.apply_camodc_high(jnp.asarray(psi, jnp.complex64), C, A, c_phys, M))
    want = _mhigh_oracle_reference(psi, C, A, c_phys, n_minus_m, M)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("ca,cb,n_minus_m", [(13, 14, 15), (13, 16, 17), (14, 15, 16)])
def test_mhigh_ladder_pair_matches_sequential(ca, cb, n_minus_m, rng):
    """A composed K=2 ladder (one gather selected by two control bits) vs
    two sequential reference oracle applies."""
    C, M = 33, 6
    A1, A2 = 29, 7
    psi = random_state(n_minus_m + M, rng)
    got = np.asarray(
        xops.apply_camodc_ladder_high(jnp.asarray(psi, jnp.complex64), C, (A1, A2), (ca, cb), M)
    )
    want = _mhigh_oracle_reference(psi, C, A1, ca, n_minus_m, M)
    want = _mhigh_oracle_reference(want, C, A2, cb, n_minus_m, M)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_engine_pairs_oracles_at_memory_ceiling(rng, monkeypatch):
    """A restricted fusion (eligible high controls, K <= 2) rewrites only
    the eligible pair into a ladder; the engine result matches the
    unfused circuit."""
    import quantumcomputer.sim.engine as eng_mod
    from quantumcomputer.models.circuit import Gate

    C, M = 33, 6
    L = 15
    n = L + M
    circ = tuple(
        Gate("camodc_high", (c,), meta=(C, pow(29, 1 + (c % 3), C), M)) for c in (13, 14, 12, 11)
    )
    fused = eng_mod.fuse_oracle_ladders(
        circ, 0,
        eligible=lambda g: g.qubits[0] >= 13, max_run=2,
    )
    assert [g.name for g in fused] == ["camodc_ladder_high", "camodc_high", "camodc_high"]
    e_pal = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    e_xla = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high", fuse=False)
    psi = random_state(n, rng)
    s0 = jnp.stack([jnp.asarray(psi.real, jnp.float32), jnp.asarray(psi.imag, jnp.float32)])
    got = e_pal.run(circ, s0 + 0)
    want = e_xla.run(circ, s0 + 0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


def test_mhigh_oracle_complex32_exact(rng):
    """bf16 planes through the complex32 engine's oracle (single gate and a
    K=2 ladder): pure data movement, so the result must be EXACT vs the
    f32 result on the bf16-rounded input."""
    from quantumcomputer.models.circuit import Gate

    C, M = 33, 6
    L = 17
    n = L + M
    psi = random_state(n, rng)
    s16 = jnp.stack([jnp.asarray(psi.real), jnp.asarray(psi.imag)]).astype(jnp.bfloat16)
    z32 = jnp.asarray(np.asarray(s16[0], np.float32) + 1j * np.asarray(s16[1], np.float32))
    eng = StateVectorEngine(Register(L=L, M=M), dtype="complex32", layout="m_high", fuse=False)

    single = (Gate("camodc_high", (14,), meta=(C, 29, M)),)
    got = eng.run(single, s16 + 0)
    want = xops.apply_camodc_high(z32, C, 29, 14, M)
    np.testing.assert_array_equal(np.asarray(got[0], np.float32), np.asarray(jnp.real(want)))
    np.testing.assert_array_equal(np.asarray(got[1], np.float32), np.asarray(jnp.imag(want)))

    ladder = (Gate("camodc_ladder_high", (14, 15), meta=(C, M, 29, 7)),)
    got2 = eng.run(ladder, s16 + 0)
    want2 = xops.apply_camodc_high(want, C, 7, 15, M)
    np.testing.assert_array_equal(np.asarray(got2[0], np.float32), np.asarray(jnp.real(want2)))
    np.testing.assert_array_equal(np.asarray(got2[1], np.float32), np.asarray(jnp.imag(want2)))
