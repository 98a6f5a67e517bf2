"""Adjoint circuits and O(1)-memory backpropagation.

Circuits are unitary, so U^dagger(U(x)) == x and the VJP of run() is the
dagger circuit applied to the cotangent — exact, with no saved
intermediates and no per-kernel derivative rules."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.circuit import dagger_circuit
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register, StateVectorEngine
from tests.conftest import random_state


def _random_circuit(n, rng, k=25):
    gates = []
    names = ["h", "x", "y", "z", "phase", "rx", "ry", "rz"]
    for _ in range(k):
        r = rng.random()
        if r < 0.6:
            q = int(rng.integers(n))
            nm = names[int(rng.integers(len(names)))]
            p = (float(rng.random() * 3),) if nm in ("phase", "rx", "ry", "rz") else ()
            gates.append(cir.Gate(nm, (q,), p))
        elif r < 0.85:
            q0, q1 = map(int, rng.choice(n, 2, replace=False))
            nm = ["cz", "cphase", "cnot", "swap"][int(rng.integers(4))]
            p = (float(rng.random() * 3),) if nm == "cphase" else ()
            gates.append(cir.Gate(nm, (q0, q1), p))
        else:
            q = int(rng.integers(n))
            m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
            u, _ = np.linalg.qr(m)
            gates.append(cir.U1Q(q, u))
    return tuple(gates)


def test_dagger_roundtrip_random(rng):
    n = 9
    circ = _random_circuit(n, rng)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128)
    psi = random_state(n, rng)
    planar = sv.from_numpy_complex(psi, jnp.float64)
    out = eng.run(dagger_circuit(circ, 0), eng.run(circ, planar))
    np.testing.assert_allclose(eng.to_numpy(out), psi, atol=1e-12)


def test_dagger_roundtrip_shor_circuit():
    """Includes iqft_stage expansion and the camodc inverse multiplier."""
    C, a, L, M = 21, 2, 4, 5
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    state = eng.run(circ)
    back = eng.to_numpy(eng.run(dagger_circuit(circ, M), state))
    want = np.zeros(1 << (L + M), np.complex128)
    want[1] = 1.0
    np.testing.assert_allclose(back, want, atol=1e-12)


def test_vjp_is_dagger(rng):
    """jax.vjp of run == the dagger circuit applied to the cotangent."""
    n = 8
    circ = _random_circuit(n, rng, k=15)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128)
    psi = random_state(n, rng)
    planar = sv.from_numpy_complex(psi, jnp.float64)
    fn = eng._compiled_run(circ, with_norms=False)
    _, vjp = jax.vjp(fn, planar)
    ct = sv.from_numpy_complex(random_state(n, rng), jnp.float64)
    (got,) = vjp(ct)
    want = eng.to_numpy(eng.run(dagger_circuit(circ, 0), ct + 0))
    np.testing.assert_allclose(eng.to_numpy(got), want, atol=1e-12)


def test_grad_through_pallas_backend(rng):
    """End-to-end gradient of a fidelity-style loss through the engine's
    large-state gate forms (n=14): grad = planar(U^dagger w)."""
    n = 14
    circ = _random_circuit(n, rng, k=12)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    psi = random_state(n, rng)
    planar = sv.from_numpy_complex(psi, jnp.float32)
    w = random_state(n, rng)
    w_planar = sv.from_numpy_complex(w, jnp.float32)
    run = eng._compiled_run(circ, with_norms=False)

    def loss(p):
        out = run(p)
        return jnp.sum(out * w_planar)

    g = jax.grad(loss)(planar)
    # d loss / d p = U^T w_planar (real-linear transpose) = planar(U^dag w)
    z = w.copy()
    for gate in dagger_circuit(circ, 0):
        if len(gate.qubits) == 1:
            z = ref.apply_1q(z, cir.gate_matrix_1q(gate), gate.qubits[0])
        else:
            q_hi, q_lo = gate.qubits if gate.qubits[0] > gate.qubits[1] else (gate.qubits[1], gate.qubits[0])
            m4 = cir.gate_matrix_2q(gate)
            if gate.qubits[0] < gate.qubits[1]:
                p = [0, 2, 1, 3]
                m4 = m4[np.ix_(p, p)]
            z = ref.apply_2q(z, m4, q_hi, q_lo)
    np.testing.assert_allclose(np.asarray(g[0]) + 1j * np.asarray(g[1]), z, atol=5e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_vjp_roundtrip(rng):
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine

    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, mesh=build_mesh(num_devices=8))
    fn = eng._compiled_run(circ)
    planar = eng.initial_state()
    _, vjp = jax.vjp(fn, planar)
    ct = eng.run(circ)  # cotangent = U|0..01>; vjp should give back |0..01>
    (got,) = vjp(ct)
    want = np.zeros(1 << (L + M), np.complex128)
    want[1] = 1.0
    np.testing.assert_allclose(eng.to_numpy(got), want, atol=1e-12)
