"""expectation_on_engine: observables through the engine gate path,
single-chip and sharded, vs the dense NumPy oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantumcomputer.algorithms.variational import (
    dense_hamiltonian,
    expectation_on_engine,
    heisenberg_hamiltonian,
    pauli_term,
    tfim_hamiltonian,
)
from quantumcomputer.models import circuit as cir
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _prep_circuit(n):
    """A non-trivial entangled state touching every qubit."""
    gates = [cir.H(q) for q in range(0, n, 2)]
    gates += [cir.CNOT(q, q + 1) for q in range(0, n - 1, 2)]
    gates += [cir.RY(q, 0.3 + 0.11 * q) for q in range(n)]
    gates += [cir.CZ(q, (q + 2) % n) for q in range(0, n - 1)]
    gates += [cir.T(0), cir.S(n - 1)]
    return tuple(gates)


def _dense_expect(psi, terms, n):
    H = dense_hamiltonian(terms, n)
    return float(np.real(psi.conj() @ H @ psi))


def test_single_chip_matches_dense():
    n = 5
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128)
    state = eng.run(_prep_circuit(n), eng.zero_state())
    psi = eng.to_numpy(state + 0)
    terms = tfim_hamiltonian(n, J=1.1, h=0.6) + [pauli_term(0.5, {})]
    got = expectation_on_engine(eng, state, terms)
    assert got == pytest.approx(_dense_expect(psi, terms, n), abs=1e-10)
    # state was not consumed: a second evaluation agrees
    assert expectation_on_engine(eng, state, terms) == pytest.approx(got, abs=1e-10)


def test_sharded_matches_dense():
    """Global-qubit X/Y ride the mesh collectives; the inner product
    reduces across shards from the sharding alone."""
    n, d = 6, 3
    mesh = build_mesh(1 << d)
    eng = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128, mesh=mesh)
    state = eng.run(_prep_circuit(n))
    psi = eng.to_numpy(state + 0)
    # terms with X and Y on the globally-sharded top qubits
    terms = heisenberg_hamiltonian(n) + [
        pauli_term(0.7, {n - 1: "X"}),
        pauli_term(-0.4, {n - 2: "Y", 0: "Z"}),
    ]
    got = expectation_on_engine(eng, state, terms)
    assert got == pytest.approx(_dense_expect(psi, terms, n), abs=1e-10)


def test_sharded_c32_loose_parity():
    """bf16-storage states go through the same path (f32 accumulation)."""
    n, d = 6, 2
    mesh = build_mesh(1 << d)
    eng64 = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128,
                                     mesh=build_mesh(1 << d))
    eng32 = ShardedStateVectorEngine(Register(L=n, M=0), dtype="complex32",
                                     mesh=mesh)
    circ = _prep_circuit(n)
    terms = tfim_hamiltonian(n)
    want = expectation_on_engine(eng64, eng64.run(circ), terms)
    got = expectation_on_engine(eng32, eng32.run(circ), terms)
    assert got == pytest.approx(want, abs=0.05)
