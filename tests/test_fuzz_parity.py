"""Randomized differential fuzz over the FULL generic gate vocabulary:
random circuits of every public gate kind, engine(s) vs an independent
NumPy evaluation built only from sim/reference primitives + dense numpy
diagonals.  Complements the Shor-circuit parity suite (which exercises a
fixed gate mix) with adversarial gate interleavings."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _random_gate(rng, n, M):
    kind = rng.integers(0, 10)
    q = int(rng.integers(0, n))
    q2 = int(rng.integers(0, n - 1))
    if q2 >= q:
        q2 += 1  # distinct
    th = float(rng.uniform(0, 2 * math.pi))
    if kind == 0:
        return rng.choice([cir.H, cir.X, cir.Y, cir.Z, cir.S, cir.T])(q)
    if kind == 1:
        return cir.PHASE(q, th)
    if kind == 2:
        return rng.choice([cir.RX, cir.RY, cir.RZ])(q, th)
    if kind == 3:  # random 1q unitary
        z = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u, _ = np.linalg.qr(z)
        return cir.U1Q(q, u)
    if kind == 4:
        return cir.CNOT(q, q2)
    if kind == 5:
        return cir.CZ(q, q2)
    if kind == 6:
        return cir.CPHASE(q, q2, th)
    if kind == 7:
        return cir.SWAP(q, q2)
    if kind == 8:  # random 2q unitary
        z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
        u, _ = np.linalg.qr(z)
        hi, lo = max(q, q2), min(q, q2)
        return cir.U2Q(hi, lo, u)
    k = int(rng.integers(2, min(4, n) + 1))
    controls = tuple(int(c) for c in rng.choice(n, size=k, replace=False))
    return cir.MCPHASE(controls, th)


def _apply_reference(psi, g):
    """Independent evaluation: only sim/reference strided contractions and
    explicit numpy diagonals — no engine code."""
    from quantumcomputer.models.circuit import gate_matrix_1q, gate_matrix_2q

    n = psi.shape[0].bit_length() - 1
    if g.name == "mcphase":
        idx = np.arange(1 << n)
        mask = np.ones(1 << n, bool)
        for c in g.qubits:
            mask &= ((idx >> c) & 1) == 1
        out = psi.copy()
        out[mask] *= np.exp(1j * g.params[0])
        return out
    if len(g.qubits) == 1:
        return ref.apply_1q(psi, gate_matrix_1q(g), g.qubits[0])
    m4 = gate_matrix_2q(g)
    q_hi, q_lo = g.qubits
    if q_hi < q_lo:
        q_hi, q_lo = q_lo, q_hi
        p = [0, 2, 1, 3]
        m4 = m4[np.ix_(p, p)]
    return ref.apply_2q(psi, m4, q_hi, q_lo)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_xla_engine_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 9
    circ = tuple(_random_gate(rng, n, 0) for _ in range(30))
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128)
    got = eng.to_numpy(eng.run(circ, eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[0] = 1.0
    for g in circ:
        want = _apply_reference(want, g)
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-12


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_fuzz_sharded_engine_vs_oracle(seed):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    rng = np.random.default_rng(100 + seed)
    n = 8
    circ = tuple(_random_gate(rng, n, 0) for _ in range(20))
    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64, mesh=mesh)
    got = eng.to_numpy(eng.run(circ, eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[0] = 1.0
    for g in circ:
        want = _apply_reference(want, g)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("seed", (0, 1))
def test_fuzz_pallas_engine_vs_oracle(seed):
    """The engine at n=14 (large-state gate forms) on a random generic
    circuit: same amplitudes as the independent evaluation."""
    rng = np.random.default_rng(200 + seed)
    n = 14
    circ = tuple(_random_gate(rng, n, 0) for _ in range(16))
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    got = eng.to_numpy(eng.run(circ, eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[0] = 1.0
    for g in circ:
        want = _apply_reference(want, g)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("seed", (0, 1))
def test_fuzz_sharded_dd_engine_vs_oracle(seed):
    """The dd mesh engine is now fully generic (dense 2q on global qubits
    included): random full-vocabulary circuits at f64-grade parity."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded_dd import ShardedDDStateVectorEngine

    rng = np.random.default_rng(300 + seed)
    n = 7
    circ = tuple(_random_gate(rng, n, 0) for _ in range(16))
    mesh = build_mesh(num_devices=4)
    eng = ShardedDDStateVectorEngine(Register(L=n, M=0), mesh=mesh)
    got = eng.to_numpy(eng.run(circ, eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[0] = 1.0
    for g in circ:
        want = _apply_reference(want, g)
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("seed", (0, 1))
def test_fuzz_sharded_c32_engine_vs_oracle(seed):
    """The bf16-planes mesh path over the full vocabulary (bf16 storage
    tolerance): plane-pair collectives + f32 blends for every gate kind."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    rng = np.random.default_rng(400 + seed)
    n = 8
    circ = tuple(_random_gate(rng, n, 0) for _ in range(14))
    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(
        Register(L=n, M=0), dtype="complex32", mesh=mesh
    )
    got = eng.to_numpy(eng.run(circ, eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[0] = 1.0
    for g in circ:
        want = _apply_reference(want, g)
    # bf16 storage: ~8 mantissa bits per step; 14 gates compound.
    np.testing.assert_allclose(got, want, atol=0.06)
    assert abs(np.linalg.norm(got) - 1.0) < 0.03
