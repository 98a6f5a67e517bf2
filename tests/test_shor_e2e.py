"""End-to-end Shor factorizations: the reference's demonstrated range
(15, 21, 33 — qc_shor.c:26-29, 76-81, Report §IV.B), forced and trial-loop
paths, warnings, and the no-remeasure semantic."""

import jax.numpy as jnp
import pytest

from quantumcomputer.algorithms.shor import Outcome, issue_warnings, read_omega, shors_algorithm


def test_factor_15_forced():
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128)
    assert res.ok and res.factors == (5, 3)
    assert res.period == 4
    assert res.a == 7


def test_factor_21_forced():
    res = shors_algorithm(C=21, L=4, M=5, forced_trial_int=2, seed=1, dtype=jnp.complex128)
    assert res.ok and res.factors == (7, 3)
    assert res.period == 6


def test_factor_33_forced():
    res = shors_algorithm(C=33, L=5, M=6, forced_trial_int=7, seed=2, dtype=jnp.complex128)
    assert res.ok and res.factors == (11, 3)


def test_factor_15_trial_loop():
    # Unforced path: a=2 is coprime to 15 with period 4 -> usually succeeds
    # immediately; a=3 shares a factor and must short-circuit classically if
    # reached.  Either way the factorization must be correct.
    res = shors_algorithm(C=15, L=3, M=4, seed=3, dtype=jnp.complex128)
    assert res.ok
    assert res.factors is not None
    f0, f1 = res.factors
    assert f0 * f1 == 15 and {f0, f1} == {3, 5}


def test_factor_gcd_shortcut():
    # Forced a sharing a factor with C resolves classically (textbook Shor;
    # the reference would run a non-unitary gate here, SURVEY.md §4/§7).
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=6, seed=0, dtype=jnp.complex128)
    assert res.ok and res.factors == (5, 3)


def test_bad_arguments():
    assert shors_algorithm(C=2, L=3, M=4).outcome is Outcome.BAD_ARGUMENTS
    assert shors_algorithm(C=15, L=0, M=4).outcome is Outcome.BAD_ARGUMENTS


def test_warnings_surface():
    # qc_shor.c:340-351 semantics: 2^M < C warns; 2^L < C^2 warns.
    w = issue_warnings(15, 3, 4)
    assert len(w) == 1 and "L register" in w[0]
    w = issue_warnings(15, 3, 3)
    assert len(w) == 2
    w = issue_warnings(15, 8, 4)
    assert w == []


def test_complex64_end_to_end():
    # Throughput dtype must still factor (probabilities well-separated).
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex64)
    assert res.ok and res.factors == (5, 3)


def test_attempt_records():
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128)
    assert len(res.attempts) == 1
    att = res.attempts[0]
    assert att.a == 7
    assert att.omega in (0.0, 0.25, 0.5, 0.75)
    assert res.elapsed_s > 0


def test_determinism_same_seed():
    # Deterministic-reduction / reproducibility guarantee (SURVEY.md §5):
    # identical seeds produce identical measurement records.
    r1 = shors_algorithm(C=21, L=4, M=5, forced_trial_int=2, seed=99, dtype=jnp.complex128)
    r2 = shors_algorithm(C=21, L=4, M=5, forced_trial_int=2, seed=99, dtype=jnp.complex128)
    assert [a.measured_index for a in r1.attempts] == [a.measured_index for a in r2.attempts]
    assert r1.factors == r2.factors


def test_cf_depth_knobs():
    # Runtime-tunable continued-fraction depth (compile-time constant in the
    # reference, qc_shor.c:58-61): depth 1 with 1 trial cannot certify the
    # period-6 case through denominator 1 alone.
    res = shors_algorithm(
        C=21, L=4, M=5, forced_trial_int=2, seed=1, dtype=jnp.complex128,
        num_fractions=1, trials_per_denominator=1,
    )
    assert res.outcome is not None  # runs; typically PERIOD_NOT_FOUND


def test_factor_35():
    # Reference note (qc_shor.c:78-79): 35 factorable; needs 2^M >= 35.
    res = shors_algorithm(C=35, L=6, M=6, forced_trial_int=2, seed=1, dtype=jnp.complex128)
    assert res.ok and res.factors == (7, 5)
    assert res.period == 12  # beyond the 10-multiple sweep: exercises CF


def test_factor_39():
    # Report §IV.A's configuration (factoring 39 at L=6, M=6).
    res = shors_algorithm(C=39, L=6, M=6, forced_trial_int=7, seed=1, dtype=jnp.complex128)
    assert res.ok and res.factors == (13, 3)


def test_undersized_M_rejected():
    # The reference silently wraps oracle indices when 2^M < C (non-unitary);
    # we refuse with a clear error (the CLI warning explains the bound).
    import pytest as _pytest

    with _pytest.raises(ValueError, match="not unitary"):
        shors_algorithm(C=35, L=5, M=5, forced_trial_int=2, seed=0, dtype=jnp.complex128)


def test_batched_sampling():
    # Statistics convenience: batched shots from the final state without
    # collapse; distribution must match the omega harmonics.
    import jax
    import numpy as np
    from quantumcomputer.algorithms.shor import read_omega
    from quantumcomputer.models.shor_circuit import shor_circuit
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    state = eng.run(shor_circuit(15, 7, 3, 4))
    idx = np.asarray(eng.sample(state, jax.random.PRNGKey(0), shots=400))
    assert idx.shape == (400,)
    omegas = {read_omega(int(i), 3, 4) for i in idx}
    assert omegas <= {0.0, 0.25, 0.5, 0.75}


def test_run_norm_and_measure_index_match_full_programs():
    """The memory-ceiling-safe folded programs (scalar outputs only) agree
    with the full-output programs: run_norm == norm(run()), and
    run_and_measure_index draws the same index as run_and_measure for the
    same key (identical sampling logic, collapse DCE'd)."""
    import jax
    import jax.numpy as jnp

    from quantumcomputer.models.shor_circuit import shor_circuit
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    circ = shor_circuit(15, 7, 3, 4)
    norm = eng.run_norm(circ)
    state = eng.run(circ)
    assert abs(norm - float(eng.norm(state))) < 1e-6
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        idx1 = eng.run_and_measure_index(circ, key)
        idx2, _ = eng.run_and_measure(circ, key)
        assert idx1 == idx2


def test_ladder_memory_gate_disables_fusion(monkeypatch):
    """Above the ladder memory limit the planner must fall back to per-gate
    (in-place) oracles and still produce the same state."""
    import jax.numpy as jnp
    import numpy as np

    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer.sim import engine as eng_mod
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    C, a, L, M = 8191, 3, 3, 13
    circ = shor_circuit_mhigh(C, a, L, M)
    e1 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    s_ladder = np.asarray(e1.run(circ))
    monkeypatch.setenv("QC_HBM_BYTES", "0")
    e2 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    s_pergate = np.asarray(e2.run(circ))
    np.testing.assert_allclose(s_ladder, s_pergate, atol=2e-6)
