"""JAX XLA-path ops vs the NumPy oracle: every gate kind, random states,
<=1e-12 amplitude parity in complex128 (the SURVEY.md §4(d) target)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine, apply_gate
from tests.conftest import random_state

ATOL = 1e-12


@pytest.mark.parametrize("n,q", [(4, 0), (4, 2), (4, 3), (7, 0), (7, 5)])
def test_apply_1q_parity(n, q, rng):
    psi = random_state(n, rng)
    got = np.asarray(xops.apply_1q(jnp.asarray(psi), jnp.asarray(ref.HADAMARD), q))
    want = ref.apply_hadamard(psi, q)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,c,t", [(4, 3, 0), (4, 3, 2), (6, 5, 1)])
def test_apply_c_phase_parity(n, c, t, rng):
    psi = random_state(n, rng)
    theta = math.pi / 8
    got = np.asarray(xops.apply_c_phase(jnp.asarray(psi), c, t, theta))
    want = ref.apply_c_phase(psi, c, t, theta)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,hi,lo", [(4, 3, 0), (5, 4, 2), (5, 2, 1)])
def test_apply_2q_parity(n, hi, lo, rng):
    psi = random_state(n, rng)
    # random 4x4 unitary via QR
    m = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    u4, _ = np.linalg.qr(m)
    got = np.asarray(xops.apply_2q(jnp.asarray(psi), jnp.asarray(u4), hi, lo))
    want = ref.apply_2q(psi, u4, hi, lo)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("C,A,M,c_q,n", [(15, 7, 4, 5, 7), (15, 13, 4, 4, 6), (21, 2, 5, 6, 8)])
def test_apply_c_amodc_parity(C, A, M, c_q, n, rng):
    psi = random_state(n, rng)
    got = np.asarray(xops.apply_c_amodc(jnp.asarray(psi), C, A, c_q, M))
    want = ref.apply_c_amodc(psi, C, A, c_q, M)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_apply_c_amodc_rejects_non_coprime():
    psi = jnp.asarray(ref.initial_state(6))
    with pytest.raises(ValueError):
        xops.apply_c_amodc(psi, 15, 6, 5, 4)


@pytest.mark.parametrize("L,M", [(3, 2), (4, 3), (5, 1)])
def test_fused_iqft_stage_matches_gate_ladder(L, M, rng):
    n = L + M
    psi = random_state(n, rng)
    got = np.asarray(xops.apply_inverse_qft(jnp.asarray(psi), L, M))
    want = ref.inverse_qft(psi, L, M)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_iqft_is_inverse_of_dft():
    # The inverse QFT with bit-reversed readout decodes a phase ramp
    # e^{-2 pi i k x / 2^L} on the L register to omega = k / 2^L exactly
    # (the Candela convention: positive ladder phases + bit-reversed readout).
    L, M = 4, 1
    n = L + M
    dim_L = 1 << L
    # Build state: uniform phase ramp on the L register, M register |0>.
    psi = np.zeros(1 << n, dtype=np.complex128)
    k = 5
    for x in range(dim_L):
        # L-register value x as stored in qubits [M, N) in normal order
        psi[x << M] = np.exp(-2j * np.pi * k * x / dim_L) / math.sqrt(dim_L)
    out = np.asarray(xops.apply_inverse_qft(jnp.asarray(psi), L, M))
    probs = np.abs(out) ** 2
    best = int(np.argmax(probs))
    # decode with the bit-reversed convention
    from quantumcomputer.algorithms.shor import read_omega

    assert probs[best] > 0.999
    assert read_omega(best, L, M) == k / dim_L


def test_standard_gate_dispatch_vs_dense(rng):
    """Every generic gate through the engine dispatch vs dense matrix algebra."""
    n = 5
    M = 0
    gates = [
        cir.H(2),
        cir.X(0),
        cir.Y(4),
        cir.Z(1),
        cir.S(3),
        cir.T(0),
        cir.PHASE(2, 0.3),
        cir.RX(1, 0.9),
        cir.RY(3, -1.2),
        cir.RZ(4, 2.2),
        cir.CNOT(3, 1),
        cir.CNOT(1, 3),
        cir.CZ(4, 0),
        cir.CPHASE(2, 0, 0.77),
        cir.SWAP(0, 4),
        cir.SWAP(4, 2),
    ]
    psi = random_state(n, rng)
    state = jnp.asarray(psi)
    want = psi.copy()
    for g in gates:
        state = apply_gate(state, g, M)
        if len(g.qubits) == 1:
            mat = ref.dense_gate_matrix_1q(cir.gate_matrix_1q(g), g.qubits[0], n)
        else:
            q0, q1 = g.qubits
            m4 = cir.gate_matrix_2q(g)
            if q0 < q1:
                p = [0, 2, 1, 3]
                m4 = m4[np.ix_(p, p)]
                q0, q1 = q1, q0
            mat = ref.dense_gate_matrix_2q(m4, q0, q1, n)
        want = mat @ want
        np.testing.assert_allclose(np.asarray(state), want, atol=ATOL, err_msg=str(g))


def test_random_circuit_cross_check(rng):
    """BASELINE config #2: random dense circuit vs CPU linear algebra."""
    n = 6
    psi = random_state(n, rng)
    state = jnp.asarray(psi)
    want = psi.copy()
    names = ["h", "x", "y", "z", "phase", "rx", "ry", "rz"]
    for step in range(60):
        if rng.random() < 0.6:
            q = int(rng.integers(n))
            name = names[int(rng.integers(len(names)))]
            g = cir.Gate(name, (q,), (float(rng.random() * 3),) if name in ("phase", "rx", "ry", "rz") else ())
            mat = ref.dense_gate_matrix_1q(cir.gate_matrix_1q(g), q, n)
        else:
            q0, q1 = rng.choice(n, size=2, replace=False)
            name = ["cnot", "cz", "cphase", "swap"][int(rng.integers(4))]
            g = cir.Gate(name, (int(q0), int(q1)), (float(rng.random() * 3),) if name == "cphase" else ())
            m4 = cir.gate_matrix_2q(g)
            a, b = int(q0), int(q1)
            if a < b:
                p = [0, 2, 1, 3]
                m4 = m4[np.ix_(p, p)]
                a, b = b, a
            mat = ref.dense_gate_matrix_2q(m4, a, b, n)
        state = apply_gate(state, g, 0)
        want = mat @ want
    np.testing.assert_allclose(np.asarray(state), want, atol=1e-11)
    assert abs(np.sum(np.abs(np.asarray(state)) ** 2) - 1) < 1e-12


def test_measurement_semantics_parity(rng):
    psi = random_state(6, rng)
    state = jnp.asarray(psi)
    for r in [0.0, 0.1, 0.5, 0.999, 1.0 + 1e-9]:
        got = int(xops.sample_index(state, jnp.asarray(r)))
        want = ref.measure_index(psi, r)
        assert got == want, f"r={r}: {got} != {want}"


def test_collapse():
    psi = jnp.asarray(ref.initial_state(4))
    idx, collapsed = xops.measure(psi, __import__("jax").random.PRNGKey(0))
    assert int(idx) == 1
    c = np.asarray(collapsed)
    assert c[1] == 1.0 and np.sum(np.abs(c) ** 2) == 1.0


def test_apply_2q_roll_path_matches_einsum(rng):
    """The layout-safe roll form (large states) vs the reference contraction."""
    n = 14  # dim 16384 >= _SMALL_DIM
    psi = random_state(n, rng)
    z = jnp.asarray(psi)
    m = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    u4, _ = np.linalg.qr(m)
    for hi, lo in ((13, 0), (9, 3), (13, 12), (7, 6), (1, 0)):
        got = np.asarray(xops.apply_2q(z, jnp.asarray(u4), hi, lo))
        want = ref.apply_2q(psi, u4, hi, lo)
        np.testing.assert_allclose(got, want, atol=1e-12, err_msg=f"{hi},{lo}")


def test_deep_random_circuit_fused_pallas(rng):
    """200-gate random circuit through the engine at n=14 vs oracle."""
    from quantumcomputer.models import circuit as cir
    from quantumcomputer.sim.engine import Register, StateVectorEngine
    from quantumcomputer.sim import statevec as sv

    n = 14
    psi = random_state(n, rng)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    state = sv.from_numpy_complex(psi, jnp.float32)
    names = ["h", "x", "y", "z", "phase", "rx", "ry", "rz"]
    gates = []
    want = psi.copy()
    for _ in range(200):
        r = rng.random()
        if r < 0.7:
            q = int(rng.integers(n))
            nm = names[int(rng.integers(len(names)))]
            g = cir.Gate(nm, (q,), (float(rng.random() * 3),) if nm in ("phase", "rx", "ry", "rz") else ())
            want = ref.apply_1q(want, cir.gate_matrix_1q(g), q)
        else:
            q0, q1 = map(int, rng.choice(n, size=2, replace=False))
            nm = ["cz", "cphase"][int(rng.integers(2))]
            g = cir.Gate(nm, (q0, q1), (float(rng.random() * 3),) if nm == "cphase" else ())
            hi, lo = (q0, q1) if q0 > q1 else (q1, q0)
            theta = g.params[0] if nm == "cphase" else math.pi
            want = ref.apply_c_phase(want, hi, lo, theta)
        gates.append(g)
    out = eng.to_numpy(eng.run(tuple(gates), state))
    np.testing.assert_allclose(out, want, atol=3e-4)  # 200 f32 gates of drift
    assert abs(np.sum(np.abs(out) ** 2) - 1) < 1e-3
