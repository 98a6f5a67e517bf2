"""dd64 semiclassical parity: the double-float per-step driver
(algorithms/semiclassical_dd.py) must match the complex128 engine — the
same bar sim/dd_engine.py meets for the full-register circuit.

The complex128 run_semiclassical path computes every branch weight in
f64 (the conftest enables x64 on the CPU suite), so it is the oracle:
forced-branch conditional probabilities must agree to <= 1e-12 across
whole attempts, where a plain f32 run drifts at ~1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.semiclassical import (
    find_period_semiclassical,
    run_semiclassical,
)


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (33, 29, 3, 6)])
def test_dd_branch_probs_match_complex128(C, a, L, M):
    """Every branch's conditional probabilities at dd64 equal the f64
    oracle's to 1e-12 (live branches; dead branches agree on deadness)."""
    for branch in range(1 << L):
        forced = [(branch >> k) & 1 for k in range(L)]
        rec_dd = run_semiclassical(
            C, a, L, M, jax.random.PRNGKey(0), dtype="dd64", forced_bits=forced
        )
        rec_64 = run_semiclassical(
            C, a, L, M, jax.random.PRNGKey(0), dtype=jnp.complex128, forced_bits=forced
        )
        assert rec_dd.bits == rec_64.bits
        assert rec_dd.x_tilde == rec_64.x_tilde
        for p_dd, p_64 in zip(rec_dd.branch_probs, rec_64.branch_probs):
            if not np.isfinite(p_64) or p_64 < 1e-12:
                # dead/garbage branch: forcing a zero-probability outcome
                # leaves meaningless downstream conditionals by design
                break
            assert abs(float(p_dd) - float(p_64)) <= 1e-12


def test_dd_beats_f32_on_accumulated_drift():
    """Over a long attempt (L=20 sequential renormalized steps) the dd64
    conditionals sit within 1e-12 of f64 where complex64's drift is
    visible — the reason a parity mode exists for this engine."""
    C, a, L, M = 33, 29, 20, 6
    forced = [0] * L  # the all-zeros branch stays live (omega = 0 branch)
    rec_64 = run_semiclassical(
        C, a, L, M, jax.random.PRNGKey(0), dtype=jnp.complex128, forced_bits=forced
    )
    rec_dd = run_semiclassical(
        C, a, L, M, jax.random.PRNGKey(0), dtype="dd64", forced_bits=forced
    )
    rec_32 = run_semiclassical(
        C, a, L, M, jax.random.PRNGKey(0), dtype=jnp.complex64, forced_bits=forced
    )
    err_dd = max(
        abs(float(d) - float(o)) for d, o in zip(rec_dd.branch_probs, rec_64.branch_probs)
    )
    err_32 = max(
        abs(float(f) - float(o)) for f, o in zip(rec_32.branch_probs, rec_64.branch_probs)
    )
    assert err_dd <= 1e-12
    assert err_dd < err_32  # the parity mode actually buys precision


def test_dd_end_to_end_period_and_factors():
    """Unforced dd64 attempt recovers a usable period for C=15 (driver-level
    pipeline: omega -> continued fractions -> period test)."""
    period, rec = find_period_semiclassical(
        15, 7, 3, 4, jax.random.PRNGKey(3), dtype="dd64"
    )
    assert len(rec.bits) == 3
    assert all(b in (0, 1) for b in rec.bits)
    if period is not None:
        assert pow(7, period, 15) == 1


def test_dd_shors_algorithm_semiclassical():
    from quantumcomputer.algorithms.shor import shors_algorithm

    # seed chosen so the forced-a attempt draws a period-revealing branch
    for seed in range(8):
        res = shors_algorithm(
            C=15, L=3, M=4, forced_trial_int=7, seed=seed, dtype="dd64",
            semiclassical=True,
        )
        if res.ok:
            assert sorted(res.factors) == [3, 5]
            return
    raise AssertionError("no seed in 0..7 factored 15 at dd64 (distribution bug?)")


def test_dd_semiclassical_guards():
    from quantumcomputer.parallel.mesh import build_mesh

    with pytest.raises(ValueError, match="single-chip"):
        find_period_semiclassical(
            15, 7, 3, 4, jax.random.PRNGKey(0), dtype="dd64", mesh=build_mesh(2)
        )
    with pytest.raises(ValueError, match="checkpoint"):
        run_semiclassical(
            15, 7, 3, 4, jax.random.PRNGKey(0), dtype="dd64", checkpoint_dir="/tmp/x"
        )


def test_cli_accepts_and_guards_dd64_semiclassical():
    from quantumcomputer.cli import build_parser, validate

    p = build_parser()
    ok = p.parse_args(
        ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--dtype", "dd64"]
    )
    assert validate(ok) is None
    sharded = p.parse_args(
        ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--dtype", "dd64",
         "--devices", "2"]
    )
    assert "single-chip" in validate(sharded)
    ck = p.parse_args(
        ["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--dtype", "dd64",
         "--checkpoint-dir", "/tmp/x"]
    )
    assert "checkpoint" in validate(ck)
