"""Double-float (dd64) parity mode: f64-equivalent accuracy from f32 pairs.

The dd engine must match the float64 CPU oracle to <= 1e-12 on full Shor
circuits — the BASELINE.json north-star parity envelope, achieved with
f32 arithmetic only (no x64 arrays in these tests).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_reference
from quantumcomputer.ops import dd
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.dd_engine import DDStateVectorEngine
from quantumcomputer.sim.engine import Register
from tests.conftest import random_state


def test_dd_arithmetic_precision():
    """Core dd ops keep ~49-bit accuracy: sums/products of adversarial f64
    values round-trip to <= 2^-48 relative error."""
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(1024) * np.exp(rng.standard_normal(1024) * 3)
    b64 = rng.standard_normal(1024) * np.exp(rng.standard_normal(1024) * 3)
    a = tuple(map(jnp.asarray, dd.split_f64(a64)))
    b = tuple(map(jnp.asarray, dd.split_f64(b64)))
    s = dd.to_f64(dd.add(a, b))
    p = dd.to_f64(dd.mul(a, b))
    # Error scaled by INPUT magnitude (under cancellation no finite format
    # bounds output-relative error); ~2^-48 is the dd unit roundoff.
    rel_s = np.abs(s - (a64 + b64)) / np.maximum(np.abs(a64) + np.abs(b64), 1e-300)
    rel_p = np.abs(p - a64 * b64) / np.maximum(np.abs(a64 * b64), 1e-300)
    assert rel_s.max() < 2**-47, rel_s.max()
    # dd mul drops the lo*lo term: worst case ~4u^2 = 2^-46 relative.
    assert rel_p.max() < 2**-45, rel_p.max()


def test_dd_tree_sum_exactness():
    """tree_sum beats naive f32 summation by ~7 digits on a hard case."""
    rng = np.random.default_rng(1)
    x64 = rng.standard_normal(4096)
    x = tuple(map(jnp.asarray, dd.split_f64(x64)))
    got = float(dd.to_f64(dd.tree_sum(x)))
    want = math.fsum(x64.tolist())
    assert abs(got - want) < 1e-12 * max(1.0, abs(want))


CASES = [
    (15, 7, 3, 4),
    (15, 13, 3, 4),
    (21, 2, 4, 5),
    (33, 7, 5, 6),  # n = 11
]


@pytest.mark.parametrize("C,a,L,M", CASES)
def test_dd_full_circuit_parity_1e12(C, a, L, M):
    """Full-circuit amplitudes vs the f64 oracle: <= 1e-12 (north star)."""
    eng = DDStateVectorEngine(Register(L=L, M=M))
    got = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_dd_reference_form_parity():
    """Gate-for-gate circuit form (every cphase separate) also holds 1e-12."""
    C, a, L, M = 21, 5, 4, 5
    eng = DDStateVectorEngine(Register(L=L, M=M))
    got = eng.to_numpy(eng.run(shor_circuit_reference(C, a, L, M)))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_dd_norm_trace_report_fig2():
    """FIG. 2 analog in dd: norm deviation at double-ish round-off through
    every gate of factoring 39 (L=6, M=6), like Report §IV.A's 2.4e-15."""
    C, a, L, M = 39, 7, 6, 6
    eng = DDStateVectorEngine(Register(L=L, M=M))
    _, norms = eng.run_with_norms(shor_circuit_reference(C, a, L, M))
    devs = np.abs(norms - 1.0)
    assert devs.max() < 1e-12, f"max dd norm deviation {devs.max():.3e}"


def test_dd_dense_2q_and_diagonals(rng):
    """Random dense/diagonal gate mix vs the oracle at 1e-12 (gate set
    coverage beyond the Shor circuit)."""
    n = 8
    psi = random_state(n, rng)
    planar4 = np.stack(
        list(dd.split_f64(psi.real)) + list(dd.split_f64(psi.imag))
    ).astype(np.float32)
    eng = DDStateVectorEngine(Register(L=n, M=0))
    gates = []
    for q in (0, 3, 7):
        m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u, _ = np.linalg.qr(m)
        gates.append(cir.U1Q(q, u))
    gates += [cir.CNOT(5, 1), cir.SWAP(6, 2), cir.CPHASE(7, 0, 0.77), cir.CZ(4, 3), cir.RZ(2, 1.1)]
    got = eng.to_numpy(eng.run(tuple(gates), jnp.asarray(planar4)))
    want = psi.copy()
    for g in gates:
        if len(g.qubits) == 1:
            want = ref.apply_1q(want, cir.gate_matrix_1q(g), g.qubits[0])
        else:
            hi, lo = (g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0]))
            m4 = cir.gate_matrix_2q(g)
            if g.qubits[0] < g.qubits[1]:
                p = [0, 2, 1, 3]
                m4 = m4[np.ix_(p, p)]
            want = ref.apply_2q(want, m4, hi, lo)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_dd_measurement_and_omega():
    """run_and_measure lands only on the four harmonics for (15,7,3,4)."""
    from quantumcomputer.algorithms.shor import read_omega

    eng = DDStateVectorEngine(Register(L=3, M=4))
    circ = shor_circuit(15, 7, 3, 4)
    key = jax.random.PRNGKey(2)
    for _ in range(20):
        key, sub = jax.random.split(key)
        idx, collapsed = eng.run_and_measure(circ, sub)
        assert read_omega(idx, 3, 4) in (0.0, 0.25, 0.5, 0.75)
    assert abs(eng.norm(collapsed) - 1.0) < 1e-6


def test_dd_shors_algorithm_e2e():
    from quantumcomputer.algorithms.shor import shors_algorithm

    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype="dd64")
    assert res.ok and res.factors == (5, 3)


def test_dd_cli():
    from quantumcomputer.cli import main

    assert main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0", "--dtype", "dd64"]) == 0
    assert main(["-C", "15", "-L", "3", "-M", "4", "--dtype", "dd64", "--layout", "m_high"]) == 2


def test_dd_folded_scalar_programs():
    """run_norm / run_and_measure_index on the dd engine: API-uniform with
    StateVectorEngine; norm at dd accuracy, same-key draw parity with
    run_and_measure."""
    import jax

    from quantumcomputer.models.shor_circuit import shor_circuit

    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = DDStateVectorEngine(Register(L=L, M=M))
    assert abs(eng.run_norm(circ) - 1.0) < 1e-12
    key = jax.random.PRNGKey(5)
    idx_only = eng.run_and_measure_index(circ, key)
    idx_full, _ = eng.run_and_measure(circ, key)
    assert idx_only == idx_full


def test_dd_folded_forms_respect_fuse_guard():
    """run_norm / run_and_measure_index never build a whole-circuit program
    (XLA:CPU corrupts dd EFTs in multi-gate fusion contexts): they route
    through the per-gate programs, so a LONG circuit keeps dd-grade norm
    accuracy."""
    import jax

    from quantumcomputer.models.shor_circuit import shor_circuit_reference

    # Gate-for-gate form: 60+ individual gates (the regime where fused CPU
    # programs measurably corrupt EFTs, ~1e-8 amplitude error).
    C, a, L, M = 21, 2, 6, 5
    circ = shor_circuit_reference(C, a, L, M)
    assert len(circ) > 25
    eng = DDStateVectorEngine(Register(L=L, M=M))
    assert not hasattr(eng, "fuse_program")  # one program per gate, always
    assert abs(eng.run_norm(circ) - 1.0) < 1e-12
    idx = eng.run_and_measure_index(circ, jax.random.PRNGKey(3))
    state = eng.run(circ, eng.initial_state())
    idx2, _ = eng.measure(state, jax.random.PRNGKey(3))
    assert idx == idx2


def test_dd_nan_checks_wired(capfd):
    """nan_checks=True actually inserts the in-program non-finite hook
    (it used to be stored and ignored)."""
    import jax

    eng = DDStateVectorEngine(Register(L=2, M=2), nan_checks=True)
    bad = jnp.full((4, 16), jnp.inf, jnp.float32)
    from quantumcomputer.models.circuit import H

    out = eng.run((H(0),), bad)
    jax.block_until_ready(out)
    captured = capfd.readouterr()
    assert "non-finite" in captured.out + captured.err
