"""Quantum Volume protocol (algorithms/quantum_volume.py): Haar SU(4)
sampling, model-circuit parity vs the complex128 oracle, and the full
pass/fail scoring on both engines.  On an ideal simulator the measured
heavy-output probability estimates the ideal heavy weight (~0.85), so the
protocol must PASS — making it a whole-stack differential test of the
dense-2q path + sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer import Register, StateVectorEngine
from quantumcomputer.algorithms.quantum_volume import (
    haar_su4,
    heavy_set,
    ideal_probabilities,
    qv_model_circuit,
    run_quantum_volume,
)


def test_haar_su4_is_special_unitary():
    rng = np.random.default_rng(0)
    for _ in range(5):
        u = haar_su4(rng)
        assert np.abs(u @ u.conj().T - np.eye(4)).max() < 1e-12
        assert abs(np.linalg.det(u) - 1.0) < 1e-12


def test_model_circuit_shape_and_validation():
    rng = np.random.default_rng(1)
    circ = qv_model_circuit(5, rng)
    assert len(circ) == 5 * 2  # m layers x floor(m/2) pairs
    assert all(g.name == "u2q" and g.qubits[0] > g.qubits[1] for g in circ)
    with pytest.raises(ValueError):
        qv_model_circuit(1, rng)
    with pytest.raises(ValueError):
        from quantumcomputer.models import circuit as cir

        ideal_probabilities((cir.H(0),), 2)


def test_engine_parity_vs_oracle():
    """The engine's output distribution on a QV circuit matches the
    complex128 NumPy oracle — a dense-2q differential across random
    qubit pairings."""
    eng = StateVectorEngine(Register(L=5, M=0), dtype=jnp.complex64)
    rng = np.random.default_rng(3)
    for _ in range(3):
        circ = qv_model_circuit(5, rng)
        state = eng.run(circ, eng.zero_state())
        p_eng = np.asarray(eng.probabilities(state))
        p_ref = ideal_probabilities(circ, 5)
        assert np.abs(p_eng - p_ref).max() < 1e-6
        assert int(heavy_set(p_ref).sum()) <= 1 << 4  # at most half are heavy


def test_qv_passes_single_chip():
    # The paper's bound has sigma^2 = p(1-p)/num_circuits (the circuit is
    # the independent unit), so certification needs enough CIRCUITS:
    # ~0.85 - 2*sqrt(0.85*0.15/40) ~ 0.74 > 2/3.
    eng = StateVectorEngine(Register(L=4, M=0), dtype=jnp.complex64)
    res = run_quantum_volume(4, eng, num_circuits=40, shots=100, seed=1)
    assert res.passed and res.quantum_volume == 16
    assert 0.7 < res.mean_hop < 1.0
    # measured HOP tracks the ideal heavy weight circuit-by-circuit
    assert np.abs(np.array(res.hops) - np.array(res.ideal_hops)).mean() < 0.1
    d = res.to_dict()
    assert d["quantum_volume"] == 16 and d["passed"] is True


def test_qv_sigma_is_per_circuit():
    """Regression for the pass criterion: few circuits must NOT certify,
    however many shots — sigma pools over circuits, not shots."""
    eng = StateVectorEngine(Register(L=3, M=0), dtype=jnp.complex64)
    res = run_quantum_volume(3, eng, num_circuits=4, shots=400, seed=7)
    expect = res.mean_hop - 2.0 * np.sqrt(res.mean_hop * (1 - res.mean_hop) / 4)
    assert abs(res.lower_2sigma - expect) < 1e-12
    assert res.lower_2sigma < res.mean_hop - 0.05  # wide bound with nc=4


def test_qv_passes_sharded():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=4, M=0), dtype=jnp.complex64, mesh=mesh)
    res = run_quantum_volume(4, eng, num_circuits=30, shots=60, seed=2)
    assert res.passed and res.quantum_volume == 16


def test_sharded_zero_state():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=3, M=3), dtype=jnp.complex64, mesh=mesh)
    z = np.asarray(eng.to_numpy(eng.zero_state()))
    assert z[0] == 1.0 and np.abs(z[1:]).max() == 0.0


def test_qv_passes_complex32():
    """The dtype matrix extends to bf16 storage: heavy-set membership is
    robust to complex32's ~1e-3 probability error (the heavy/light gap at
    m=4 is ~p_median), so certification still succeeds."""
    eng = StateVectorEngine(Register(L=4, M=0), dtype="complex32")
    res = run_quantum_volume(4, eng, num_circuits=30, shots=80, seed=5)
    assert res.passed and res.quantum_volume == 16
    assert 0.75 < res.mean_hop < 1.0
