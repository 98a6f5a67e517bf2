"""MCPHASE primitive + Grover search: the generic-algorithm proof.

The reference simulator is Shor-only; these tests pin the rebuild's claim
to be a general engine — a complete second algorithm runs unchanged on
the single-device engine (complex64 and complex32) and the sharded mesh.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.grover import (
    grover_circuit,
    grover_iterations,
    grover_search,
)
from quantumcomputer.models.circuit import H, MCPHASE, MCZ, PHASE, RY, dagger_circuit
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _rand_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (v / np.linalg.norm(v)).astype(np.complex64)


def _mcphase_numpy(psi, controls, theta):
    out = psi.astype(np.complex128).copy()
    mask = 0
    for q in controls:
        mask |= 1 << q
    idx = np.arange(out.shape[0])
    out[(idx & mask) == mask] *= np.exp(1j * theta)
    return out


@pytest.mark.parametrize(
    "controls", [(0,), (3,), (0, 1), (2, 5, 7), (0, 1, 2, 3, 4, 5, 6, 7)]
)
def test_mcphase_matches_numpy(controls):
    n, theta = 8, 0.73
    psi = _rand_state(n, 1)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    got = eng.to_numpy(eng.run((MCPHASE(controls, theta),), sv.from_numpy_complex(psi)))
    want = _mcphase_numpy(psi, controls, theta)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mcphase_dagger_is_inverse():
    n = 6
    circ = (MCPHASE((1, 3, 4), 1.234), MCZ(0, 2, 5))
    psi = _rand_state(n, 2)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    state = eng.run(circ, sv.from_numpy_complex(psi))
    back = eng.to_numpy(eng.run(dagger_circuit(circ), state))
    np.testing.assert_allclose(back, psi, atol=1e-6)


def test_mcphase_sharded_matches_single_chip():
    """Controls spanning global AND local qubits on an 8-device mesh; the
    global bits must resolve communication-free per device.  A structured
    prefix (H / RY / PHASE layers) builds a non-trivial state from reset on
    both engines, then the masked phase is compared amplitude-for-amplitude."""
    n, theta = 9, 2.1
    controls = (0, 2, 6, 7, 8)  # d=3 -> qubits 6,7,8 are global
    prefix = tuple(H(q) for q in range(n)) + tuple(
        RY(q, 0.1 + 0.2 * q) for q in range(n)
    ) + (PHASE(4, 0.9),)
    circ = prefix + (MCPHASE(controls, theta),)
    single = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    want = single.to_numpy(single.run(circ))
    mesh = build_mesh(8)
    eng = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64, mesh=mesh)
    got = eng.to_numpy(eng.run(circ))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mcphase_validation():
    with pytest.raises(ValueError):
        MCPHASE((), 1.0)
    with pytest.raises(ValueError):
        MCPHASE((1, 1), 1.0)


def test_grover_iterations():
    assert grover_iterations(2) == 1
    assert grover_iterations(8) == 12


@pytest.mark.parametrize("dtype", [jnp.complex64, "complex32"])
def test_grover_finds_marked_item(dtype):
    n, marked = 8, 173
    eng = StateVectorEngine(Register(L=n, M=0), dtype=dtype)
    idx, p = grover_search(n, marked, jax.random.PRNGKey(0), engine=eng)
    # r=12 iterations at n=8: sin^2((2r+1) asin(2^-4)) ~ 0.9996
    assert p > 0.99
    assert idx == marked  # a >99% draw with this key


def test_grover_probability_matches_theory():
    n, marked = 6, 40
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    for r in (1, 3, grover_iterations(n)):
        _, p = grover_search(n, marked, jax.random.PRNGKey(1), engine=eng, iterations=r)
        want = math.sin((2 * r + 1) * math.asin(1.0 / math.sqrt(1 << n))) ** 2
        assert abs(p - want) < 1e-5


def test_grover_norm_preserved():
    n = 7
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    state = eng.run(grover_circuit(n, 5))
    assert abs(float(eng.norm(state)) - 1.0) < 1e-5


def test_grover_sharded():
    """The identical circuit over an 8-device mesh: global-qubit H
    butterflies + communication-free MCZ conditions end to end."""
    n, marked = 8, 201
    mesh = build_mesh(8)
    eng = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64, mesh=mesh)
    idx, p = grover_search(n, marked, jax.random.PRNGKey(2), engine=eng)
    assert p > 0.99
    assert idx == marked
