"""Amplitude estimation (algorithms/qpe.py on the Grover iterate).

The exact-case tests pin the Q = -G_std algebra (module docstring): when
theta_a / pi is an exact t-bit fraction the counting register reads it
deterministically; the generic case pins the whole pre-measurement
distribution against the BHMT error bound.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.amplitude_estimation import amplitude_estimate


def test_exact_amplitude_half():
    """a = 1/2: theta_a = pi/4, eigenphases 1/2 +- 1/4 — exact at t = 3,
    so a_hat = 1/2 exactly for every measurement key."""
    for seed in range(4):
        est = amplitude_estimate(2, [0, 1], 3, jax.random.PRNGKey(seed))
        assert est.qpe.x in (2, 6)
        assert abs(est.a_hat - 0.5) < 1e-9


def test_exact_amplitude_quarter():
    """a = 1/4 (1 of 4 marked): theta_a = pi/6... NOT exact; use the
    self-dual point a = sin^2(pi/4)=1/2 covered above and the other exact
    family a = sin^2(pi*k/2^t).  k=1, t=2: a = 1/2 again; k=1, t=3:
    a = sin^2(pi/8) ~ 0.1464 is not a dyadic marked fraction — so instead
    pin the INEXACT single-marked case against the BHMT bound, from the
    full pre-measurement distribution (deterministic, no sampling)."""
    n, t = 3, 5
    a = 1.0 / (1 << n)
    from quantumcomputer.algorithms.qpe import qpe_circuit
    from quantumcomputer.algorithms.amplitude_estimation import (
        _controlled_grover_iterate,
    )
    from quantumcomputer.algorithms.shor import read_omega
    from quantumcomputer.models.circuit import H, X
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L=t, M=n), dtype=jnp.complex64)
    prep = (X(0),) + tuple(H(q) for q in range(n))

    def cu(j, control):
        return _controlled_grover_iterate(n, [5], control) * (1 << j)

    state = eng.run(qpe_circuit(cu, t, n, prep))
    amps = eng.to_numpy(state)
    dist = np.zeros(1 << t)
    for idx in range(1 << (t + n)):
        x_tilde = int(round(read_omega(idx, t, n) * (1 << t)))
        dist[((1 << t) - x_tilde) % (1 << t)] += abs(amps[idx]) ** 2
    assert abs(dist.sum() - 1.0) < 1e-5

    # Peak lands on the best t-bit approximation of 1/2 +- theta_a/pi, and
    # the mass within +-1 grid point of the true phases is >= 8/pi^2 (the
    # BHMT guarantee is for that neighborhood, not the single nearest
    # point, whose mass dips to ~sinc^2(delta) at rounding offset delta).
    theta = math.asin(math.sqrt(a))
    cands = {round((0.5 + s * theta / math.pi) * (1 << t)) % (1 << t) for s in (1, -1)}
    assert int(np.argmax(dist)) in cands
    hood = {(c + d) % (1 << t) for c in cands for d in (-1, 0, 1)}
    assert sum(dist[c] for c in hood) >= 8.0 / math.pi**2

    # Every candidate inverts to a_hat within the BHMT theorem-12 bound.
    for c in cands:
        a_hat = math.sin(math.pi * abs(c / (1 << t) - 0.5)) ** 2
        bound = 2 * math.pi * math.sqrt(a * (1 - a)) / (1 << t) + (math.pi / (1 << t)) ** 2
        assert abs(a_hat - a) <= bound


def test_estimate_on_mesh_engine():
    """Circuit IR end to end: the same estimate on a 4-device mesh."""
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer.sim.engine import Register

    mesh = build_mesh(4)
    eng = ShardedStateVectorEngine(Register(L=3, M=2), dtype=jnp.complex64, mesh=mesh)
    est = amplitude_estimate(2, [0, 1], 3, jax.random.PRNGKey(1), engine=eng)
    assert abs(est.a_hat - 0.5) < 1e-6


def test_validation():
    with pytest.raises(ValueError, match="empty"):
        amplitude_estimate(2, [], 3, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="outside"):
        amplitude_estimate(2, [4], 3, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="all indices"):
        amplitude_estimate(1, [0, 1], 3, jax.random.PRNGKey(0))
