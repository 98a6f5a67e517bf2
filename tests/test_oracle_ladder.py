"""Composed oracle ladder: K consecutive controlled modular multiplies as
one pass (ops/gates.apply_camodc_ladder / _high + engine.fuse_oracle_ladders).

The modular multiplications commute, so the run composes into a single
permutation selected by the control bits — must match sequential
application exactly (it IS the same unitary)."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_mhigh
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine, fuse_oracle_ladders
from tests.conftest import random_state


def test_combo_multipliers():
    C = 21
    A = [2, 4, 16]  # a=2 ladder: a^(2^j) mod 21
    combos = xops.modexp_combo_multipliers(C, A)
    for mask in range(8):
        want = 1
        for k in range(3):
            if (mask >> k) & 1:
                want = (want * pow(A[k], -1, C)) % C
        assert combos[mask] == want


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (8191, 3, 3, 13)])
def test_ladder_standard_matches_sequential(C, a, L, M, rng):
    n = L + M
    psi = random_state(n, rng)
    A_list = [pow(a, 1 << j, C) for j in range(L)]
    controls = [M + j for j in range(L)]
    z = jnp.asarray(psi)
    got = np.asarray(xops.apply_camodc_ladder(z, C, tuple(A_list), tuple(controls), M))
    want = psi.copy()
    for A, c in zip(A_list, controls):
        want = ref.apply_c_amodc(want, C, A, c, M)
    np.testing.assert_allclose(got, want, atol=0)  # same permutation: exact


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (8191, 3, 3, 13)])
def test_ladder_mhigh_matches_sequential(C, a, L, M, rng):
    n = L + M
    psi = random_state(n, rng)
    A_list = [pow(a, 1 << j, C) for j in range(L)]
    controls = list(range(L))  # physical low bits in m_high
    z = jnp.asarray(psi)
    got = np.asarray(xops.apply_camodc_ladder_high(z, C, tuple(A_list), tuple(controls), M))
    want = jnp.asarray(psi)
    for A, c in zip(A_list, controls):
        want = xops.apply_camodc_high(want, C, A, c, M)
    np.testing.assert_allclose(got, np.asarray(want), atol=0)


def test_fuse_oracle_ladders_rewrite():
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    fused = fuse_oracle_ladders(circ, M)
    names = [g.name for g in fused]
    assert names.count("camodc_ladder") == 1
    assert "camodc" not in names
    assert len(fused) == len(circ) - L + 1
    lad = fused[[g.name for g in fused].index("camodc_ladder")]
    assert lad.qubits == tuple(M + j for j in range(L))
    assert lad.meta[0] == C and lad.meta[2:] == tuple(pow(a, 1 << j, C) for j in range(L))
    # m_high variant
    circ_h = shor_circuit_mhigh(C, a, L, M)
    fused_h = fuse_oracle_ladders(circ_h, 0)
    assert [g.name for g in fused_h].count("camodc_ladder_high") == 1
    # huge C: fusion declines (int32 overflow guard)
    big = (cir.CAMODC(2**16 + 1, 3, 20), cir.CAMODC(2**16 + 1, 9, 21))
    assert fuse_oracle_ladders(big, 17) == big


def test_ladder_run_length_capped():
    """Runs longer than MAX_LADDER_RUN split: the 2^K combo table (and the
    DMA kernel's SMEM budget) cap at K=8; an unbounded run would fall back
    to the catastrophically slow XLA gather ladder."""
    from quantumcomputer.models.circuit import Gate
    from quantumcomputer.sim.engine import MAX_LADDER_RUN

    C, M = 251, 8
    gates = tuple(
        Gate("camodc_high", (c,), meta=(C, pow(3, 1 << c, C), M)) for c in range(11, 23)
    )
    fused = fuse_oracle_ladders(gates, 0)
    ladders = [g for g in fused if g.name == "camodc_ladder_high"]
    assert len(ladders) == 2  # 12 gates -> runs of 8 + 4
    assert all(len(g.qubits) <= MAX_LADDER_RUN for g in ladders)
    assert sum(len(g.qubits) for g in ladders) == 12


@pytest.mark.parametrize("controls", [(11, 12), (0, 12), (3, 7)])
def test_composed_ladder_high_matches_sequential(controls, rng):
    """The composed-run gather (one pass, multiplier selected by the control
    bits) vs sequential oracles, for high, mixed and low control bits."""
    C, M, n = 15, 4, 17
    A_list = (7, 4)
    psi = random_state(n, rng)
    got = np.asarray(
        xops.apply_camodc_ladder_high(jnp.asarray(psi, jnp.complex64), C, A_list, controls, M)
    )
    want = jnp.asarray(psi)
    for A, c in zip(A_list, controls):
        want = xops.apply_camodc_high(want, C, A, c, M)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-7)


def test_pallas_engine_partial_ladder_fusion(rng):
    """Through the engine at n=16 m_high with fusion on: the result must
    match fuse=False."""
    C, a, L, M = 8191, 3, 3, 13
    # L=3 -> controls 0,1,2: all < 10, nothing fuses; extend with manual
    # high-control oracles to exercise the mixed policy.
    from quantumcomputer.models.circuit import Gate

    n = L + M
    gates = list(shor_circuit_mhigh(C, a, L, M))
    psi = random_state(n, rng)
    from quantumcomputer.sim import statevec as sv

    state = sv.from_numpy_complex(psi, jnp.float32)
    e_on = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high", fuse=True)
    e_off = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high", fuse=False)
    a_ = e_on.to_numpy(e_on.run(tuple(gates), state))
    b_ = e_off.to_numpy(e_off.run(tuple(gates), sv.from_numpy_complex(psi, jnp.float32)))
    np.testing.assert_allclose(a_, b_, atol=3e-5)


def test_engine_runs_fused_ladder_parity():
    """Full circuit through the engine (xla, fuse on -> ladder active) vs
    the per-gate reference oracle, 1e-12."""
    C, a, L, M = 33, 7, 5, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    assert eng.fuse
    got = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    np.testing.assert_allclose(got, ref.shor_circuit(C, a, L, M), atol=1e-12)


def test_engine_fuse_off_no_rewrite():
    C, a, L, M = 15, 7, 3, 4
    e_on = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, fuse=True)
    e_off = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, fuse=False)
    a_ = e_on.to_numpy(e_on.run(shor_circuit(C, a, L, M)))
    b_ = e_off.to_numpy(e_off.run(shor_circuit(C, a, L, M)))
    np.testing.assert_allclose(a_, b_, atol=1e-14)


def test_mhigh_engine_ladder_parity():
    C, a, L, M = 33, 7, 5, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
    circ = shor_circuit_mhigh(C, a, L, M)
    got = eng.to_numpy(eng.run(circ))
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high", fuse=False)
    want = single.to_numpy(single.run(circ))
    np.testing.assert_allclose(got, want, atol=1e-14)


def test_undersized_modulus_never_fuses():
    """C > 2^m_reg must not compose into a ladder: the DMA ladder kernel
    indexes rows by (combo*j) % C, which would read past the state — the
    per-gate path raises a clean ValueError instead."""
    from quantumcomputer.models.circuit import Gate
    from quantumcomputer.sim.engine import fuse_oracle_ladders

    bad = tuple(
        Gate("camodc_high", (q,), meta=(300, A, 8)) for q, A in ((0, 7), (1, 49))
    )
    assert all(g.name == "camodc_high" for g in fuse_oracle_ladders(bad, 8))
    ok = tuple(
        Gate("camodc_high", (q,), meta=(251, A, 8)) for q, A in ((0, 7), (1, 49))
    )
    assert [g.name for g in fuse_oracle_ladders(ok, 8)] == ["camodc_ladder_high"]
