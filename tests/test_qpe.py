"""Generic quantum phase estimation (algorithms/qpe.py).

The reference has no QPE beyond its hard-coded Shor instance; these tests
pin the generic driver against closed-form QPE theory (exact t-bit phases
measure deterministically; inexact ones concentrate on the best t-bit
approximation) and against the full-register engine (semiclassical joint
branch distribution == counting-register distribution).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.qpe import (
    estimate_phase,
    qpe_circuit,
    run_semiclassical_qpe,
)
from quantumcomputer.models.circuit import CPHASE, PHASE, U2Q, H, X


def _phase_cu(phi):
    """controlled-U^(2^j) for U = PHASE(0, 2*pi*phi): a CPHASE diagonal."""

    def controlled_powers(j, control):
        return [CPHASE(control, 0, 2.0 * math.pi * phi * (1 << j))]

    return controlled_powers


def _phase_u(phi):
    """Uncontrolled U^(2^j) for the semiclassical form."""

    def powers(j):
        return [PHASE(0, 2.0 * math.pi * phi * (1 << j))]

    return powers


@pytest.mark.parametrize("k", [0, 1, 5, 11, 15])
def test_exact_phase_full_register(k):
    """U = e^{2 pi i k/16} on the |1> eigenstate: 4 counting bits read k
    exactly, with probability 1 (any measurement key)."""
    t = 4
    res = estimate_phase(_phase_cu(k / 16.0), t, 1, jax.random.PRNGKey(k))
    assert res.x == k
    assert res.phase == k / 16.0


@pytest.mark.parametrize("k", [0, 3, 8, 13])
def test_exact_phase_semiclassical(k):
    """The one-control-qubit form reads the same exact phase, and every
    branch conditional is 1 (deterministic branch)."""
    res = run_semiclassical_qpe(_phase_u(k / 16.0), 4, 1, jax.random.PRNGKey(k))
    assert res.x == k
    np.testing.assert_allclose(res.record.branch_probs, 1.0, atol=1e-6)


def test_exact_phase_semiclassical_complex32():
    """bf16 storage: angles/draws/probabilities run in f32 (the blend's
    compute dtype), so an exact 4-bit phase still reads deterministically."""
    res = run_semiclassical_qpe(
        _phase_u(6 / 16.0), 4, 1, jax.random.PRNGKey(0),
        dtype="complex32",
    )
    assert res.x == 6
    np.testing.assert_allclose(res.record.branch_probs, 1.0, atol=5e-2)


def test_prep_circuit_selects_eigenstate():
    """prep = X(0) moves the work register |1> -> |0>, the eigenvalue-1
    eigenstate of PHASE: the estimate becomes 0 regardless of phi."""
    res = estimate_phase(
        _phase_cu(11 / 16.0), 4, 1, jax.random.PRNGKey(2), prep=(X(0),)
    )
    assert res.x == 0
    res_sc = run_semiclassical_qpe(
        _phase_u(11 / 16.0), 4, 1, jax.random.PRNGKey(2), prep=(X(0),)
    )
    assert res_sc.x == 0


def test_inexact_phase_concentrates():
    """phi with more than t bits: the distribution peaks at the best t-bit
    approximation with probability >= 4/pi^2 (standard QPE bound).  Checked
    on the pre-measurement distribution via forced semiclassical branches
    (product of conditionals = joint branch probability)."""
    t, phi = 4, 0.3  # best 4-bit approximation: 5/16 = 0.3125
    best = round(phi * (1 << t))
    # forced_bits force the RAW readout (the ladder's sign convention
    # negates the phase), so the branch whose ESTIMATE is `best` has raw
    # readout -best mod 2^t; bit s of the raw readout is its s-th LSB.
    raw = ((1 << t) - best) % (1 << t)
    forced = [(raw >> s) & 1 for s in range(t)]
    res = run_semiclassical_qpe(
        _phase_u(phi), t, 1, jax.random.PRNGKey(0), forced_bits=forced
    )
    assert res.x == best
    assert res.record.probability >= 4.0 / math.pi**2


def _h_cu(j, control):
    """controlled-H^(2^j): H^2 = I, so only j = 0 contributes a gate."""
    if j != 0:
        return []
    s = 1.0 / math.sqrt(2.0)
    ch = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, s, s], [0, 0, s, -s]], np.complex128
    )
    return [U2Q(control, 0, ch)]


def _h_u(j):
    return [] if j != 0 else [H(0)]


def test_noneigenstate_distribution_parity():
    """U = H on work |1> (NOT an eigenstate): the semiclassical joint
    branch distribution over all 2^t branches must equal the full-register
    counting distribution.  H's eigenphases are 0 and 1/2 (eigenvalues
    +-1), both exact at t = 3, so only x = 0 and x = 4 carry weight:
    p(0) = |<e_+|1>|^2 = sin^2(pi/8) = (1 - 1/sqrt2)/2, p(4) = 1 - p(0)."""
    t, M = 3, 1
    # Full register: probabilities of each counting outcome from the state.
    from quantumcomputer.algorithms.shor import read_omega
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L=t, M=M), dtype=jnp.complex64)
    state = eng.run(qpe_circuit(_h_cu, t, M))
    amps = eng.to_numpy(state)
    full = np.zeros(1 << t)
    for idx in range(1 << (t + M)):
        x_tilde = int(round(read_omega(idx, t, M) * (1 << t)))
        x = ((1 << t) - x_tilde) % (1 << t)  # phase numerator (QPEResult doc)
        full[x] += abs(amps[idx]) ** 2

    semi = np.zeros(1 << t)
    for branch in range(1 << t):
        forced = [(branch >> s) & 1 for s in range(t)]
        res = run_semiclassical_qpe(
            _h_u, t, M, jax.random.PRNGKey(0), forced_bits=forced
        )
        assert res.raw == branch
        p = res.record.probability
        semi[res.x] = 0.0 if math.isnan(p) else p

    np.testing.assert_allclose(semi, full, atol=1e-6)
    p0 = (1.0 - 1.0 / math.sqrt(2.0)) / 2.0
    expect = np.zeros(1 << t)
    expect[0], expect[4] = p0, 1.0 - p0
    np.testing.assert_allclose(full, expect, atol=1e-6)


def test_qpe_recovers_shor_period():
    """QPE instantiated with the modular-multiply controlled powers IS
    find_period: the measured phase feeds the same continued-fraction
    pipeline and yields the period of a mod C."""
    from quantumcomputer.algorithms import number_theory as nt
    from quantumcomputer.models.circuit import CAMODC

    C, a, t, M = 15, 7, 3, 4

    def cu(j, control):
        return [CAMODC(C, pow(a, 1 << j, C), control)]

    period = None
    for seed in range(8):
        res = estimate_phase(cu, t, M, jax.random.PRNGKey(seed))
        # Either sign convention feeds the continued fractions (k/r and
        # -k/r share the denominator); use the raw Shor-convention readout
        # to show the interop.
        p = nt.find_period_from_omega(res.raw / float(1 << t), a, C)
        if p is not None:
            period = p
            break
    assert period == 4  # ord_15(7)


def test_qpe_on_mesh_engine():
    """The full-register form is pure circuit IR: it runs unchanged on the
    sharded mesh engine (diagonal controlled powers are communication-free
    there)."""
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer.sim.engine import Register

    t, M, k = 3, 2, 5
    mesh = build_mesh(4)
    eng = ShardedStateVectorEngine(Register(L=t, M=M), dtype=jnp.complex64, mesh=mesh)
    res = estimate_phase(_phase_cu(k / 8.0), t, M, jax.random.PRNGKey(1), engine=eng)
    assert res.x == k


def test_forced_bits_length_mismatch_raises():
    with pytest.raises(ValueError, match="forced_bits"):
        run_semiclassical_qpe(
            _phase_u(0.25), 4, 1, jax.random.PRNGKey(0), forced_bits=[1, 0]
        )


def test_engine_geometry_validation():
    """A mismatched register or a non-standard layout must raise, not
    silently return a wrong phase (the circuit hard-codes work at [0, M),
    counting at [M, M+t))."""
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    with pytest.raises(ValueError, match="does not match QPE geometry"):
        estimate_phase(
            _phase_cu(0.25), 3, 2, jax.random.PRNGKey(0),
            engine=StateVectorEngine(Register(L=4, M=2)),
        )
    with pytest.raises(ValueError, match="layout"):
        estimate_phase(
            _phase_cu(0.25), 3, 2, jax.random.PRNGKey(0),
            engine=StateVectorEngine(Register(L=3, M=2), layout="m_high"),
        )
