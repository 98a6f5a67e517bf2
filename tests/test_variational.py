"""Variational layer: Pauli observables, gradient exactness, VQE, QAOA.

Oracles: dense NumPy Pauli algebra (exact matrix expectation values and
ground energies via eigh) and finite differences for gradients — the same
trusted-CPU-oracle strategy the engine parity suite uses (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantumcomputer.algorithms.variational import (
    HardwareEfficientAnsatz,
    apply_pauli,
    dense_hamiltonian,
    expectation,
    heisenberg_hamiltonian,
    maxcut_cost_vector,
    pauli_term,
    qaoa_maxcut,
    tfim_hamiltonian,
    vqe,
)
from quantumcomputer.sim import statevec as sv

from conftest import random_state


def _dense_pauli(ops, n):
    return dense_hamiltonian([pauli_term(1.0, ops)], n)


@pytest.mark.parametrize("s", ["X", "Y", "Z"])
@pytest.mark.parametrize("q", [0, 1, 3])
def test_apply_pauli_single(rng, s, q):
    n = 4
    psi = random_state(n, rng)
    want = _dense_pauli({q: s}, n) @ psi
    got = np.asarray(apply_pauli(jnp.asarray(psi), pauli_term(1.0, {q: s})[1], n))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_apply_pauli_strings(rng):
    n = 5
    psi = random_state(n, rng)
    for _ in range(10):
        qubits = rng.choice(n, size=rng.integers(1, n + 1), replace=False)
        ops = {int(q): "XYZ"[rng.integers(3)] for q in qubits}
        term = pauli_term(1.0, ops)
        want = _dense_pauli(ops, n) @ psi
        got = np.asarray(apply_pauli(jnp.asarray(psi), term[1], n))
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_expectation_matches_dense(rng):
    n = 4
    psi = random_state(n, rng)
    terms = tfim_hamiltonian(n, J=1.3, h=0.7) + [pauli_term(0.25, {})]
    H = dense_hamiltonian(terms, n)
    want = float(np.real(psi.conj() @ H @ psi))
    planar = jnp.stack([jnp.asarray(psi.real), jnp.asarray(psi.imag)])
    got = float(expectation(planar, terms))
    assert got == pytest.approx(want, abs=1e-6)


def test_expectation_jit_real_io(rng):
    """expectation is jit-safe with real-only I/O (platform invariant:
    complex never crosses the jit boundary)."""
    n = 3
    psi = random_state(n, rng)
    planar = jnp.stack([jnp.asarray(psi.real, jnp.float32),
                        jnp.asarray(psi.imag, jnp.float32)])
    terms = heisenberg_hamiltonian(n)
    f = jax.jit(lambda p: expectation(p, terms))
    H = dense_hamiltonian(terms, n)
    want = float(np.real(psi.conj() @ H @ psi))
    assert float(f(planar)) == pytest.approx(want, abs=1e-4)


def test_pauli_term_validation():
    with pytest.raises(ValueError):
        pauli_term(1.0, [(0, "X"), (0, "Z")])  # duplicate qubit
    with pytest.raises(ValueError):
        pauli_term(1.0, {0: "Q"})
    with pytest.raises(ValueError):
        apply_pauli(jnp.zeros(8, jnp.complex64), ((5, "X"),), 3)


def test_ansatz_state_normalized():
    ans = HardwareEfficientAnsatz(n=4, depth=3)
    theta = ans.initial_parameters(jax.random.PRNGKey(7))
    planar = ans.apply(theta)
    assert float(sv.norm(planar)) == pytest.approx(1.0, abs=1e-6)
    # depth layers of RY+CZ then a closing RY layer => real amplitudes
    assert float(jnp.max(jnp.abs(planar[1]))) == 0.0


def test_energy_gradient_matches_finite_difference():
    """jax.grad through the traced ansatz == central finite differences."""
    n, depth = 3, 2
    ans = HardwareEfficientAnsatz(n, depth)
    terms = tfim_hamiltonian(n, J=1.0, h=0.9)
    theta = ans.initial_parameters(jax.random.PRNGKey(3), scale=0.7)
    theta = theta.astype(jnp.float64)

    def energy(th):
        return expectation(ans.apply(th, rdtype=jnp.float64), terms)

    g = np.asarray(jax.grad(energy)(theta))
    eps = 1e-6
    flat = np.asarray(theta, dtype=np.float64)
    for idx in [(0, 0), (1, 2), (2, 1)]:
        bump = flat.copy()
        bump[idx] += eps
        ep = float(energy(jnp.asarray(bump)))
        bump[idx] -= 2 * eps
        em = float(energy(jnp.asarray(bump)))
        fd = (ep - em) / (2 * eps)
        assert g[idx] == pytest.approx(fd, abs=1e-5)


def test_vqe_tfim_ground_state():
    """VQE reaches the exact TFIM ground energy on 4 qubits."""
    n = 4
    terms = tfim_hamiltonian(n, J=1.0, h=1.0)
    exact = float(np.linalg.eigvalsh(dense_hamiltonian(terms, n))[0])
    res = vqe(terms, n, depth=3, steps=250, learning_rate=0.08,
              key=jax.random.PRNGKey(1), restarts=3)
    assert res.energy >= exact - 1e-5 * abs(exact)  # variational bound, f32 roundoff slack
    assert res.energy <= exact + 0.02 * abs(exact)
    assert res.energies[-1] < res.energies[0]  # optimizer made progress
    # the returned state reproduces the reported energy
    psi = res.state
    H = dense_hamiltonian(terms, n)
    assert float(np.real(psi.conj() @ H @ psi)) == pytest.approx(res.energy, abs=1e-4)


def test_vqe_heisenberg():
    """Real-rotation ansatz reaches the Heisenberg XXX ground energy (the
    YY terms don't need complex amplitudes: the ground state is real)."""
    n = 3
    terms = heisenberg_hamiltonian(n)
    exact = float(np.linalg.eigvalsh(dense_hamiltonian(terms, n))[0])
    res = vqe(terms, n, depth=4, steps=350, learning_rate=0.06,
              key=jax.random.PRNGKey(5), restarts=3)
    assert res.energy >= exact - 1e-5 * abs(exact)  # f32 roundoff slack
    assert res.energy <= exact + 0.01 * abs(exact)


def test_ansatz_ring_vs_brick_expressivity():
    """Regression for the documented ring-entangler invariant subspace:
    the brick ansatz must beat the ring's 0.981-fidelity cap on the TFIM
    n=4 ground state: brick converges (< 1% energy gap) and strictly beats
    ring at the same depth/budget.  No hard LOWER bound on the ring's gap:
    a two-sided bound on an optimizer trajectory is fragile across
    jax/optax version bumps (the invariant-subspace cap itself is the
    documented characterization, re-measurable via scripts/, not a CI
    assertion)."""
    n = 4
    terms = tfim_hamiltonian(n)
    exact = float(np.linalg.eigvalsh(dense_hamiltonian(terms, n))[0])
    ring = vqe(terms, n, steps=250, learning_rate=0.08,
               key=jax.random.PRNGKey(1), restarts=2,
               ansatz=HardwareEfficientAnsatz(n, 3, entangler="ring"))
    brick = vqe(terms, n, steps=250, learning_rate=0.08,
                key=jax.random.PRNGKey(1), restarts=2,
                ansatz=HardwareEfficientAnsatz(n, 3, entangler="brick"))
    assert brick.energy < ring.energy
    assert (brick.energy - exact) / abs(exact) < 0.01


def test_maxcut_cost_vector():
    # square graph: 4-cycle; max cut = 4 (alternating assignment 0b0101)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    cost = maxcut_cost_vector(4, edges)
    assert cost.shape == (16,)
    assert cost.max() == 4.0
    assert cost[0b0101] == 4.0 and cost[0b1010] == 4.0
    assert cost[0] == 0.0 and cost[0b1111] == 0.0
    # weighted edge
    cost_w = maxcut_cost_vector(2, [(0, 1, 2.5)])
    assert cost_w[0b01] == 2.5 and cost_w[0b00] == 0.0


def test_qaoa_maxcut_square():
    """QAOA p=2 on the 4-cycle finds the optimal cut with high ratio."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    res = qaoa_maxcut(4, edges, p=2, steps=150, learning_rate=0.08,
                      key=jax.random.PRNGKey(2))
    assert res.optimal_cut == 4.0
    assert res.best_cut == 4.0  # most-probable bitstring is an optimal cut
    assert res.approximation_ratio > 0.9
    assert res.expectations[-1] > res.expectations[0]
