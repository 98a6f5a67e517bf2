"""Reference-methodology experiments: TABLE I histogram and FIG. 2 trace."""

import jax.numpy as jnp
import pytest

from quantumcomputer.sim.engine import Register, StateVectorEngine
from quantumcomputer.utils.experiments import norm_deviation_trace, omega_histogram


def test_table1_histogram_uniform_harmonics():
    # 100 runs like the Report; counts must cover exactly the period-4
    # harmonics and be within 5 sigma of uniform (sigma ~ 4.3 at p=1/4).
    hist = omega_histogram(15, 7, 3, 4, runs=100, seed=7,
                           engine=StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128))
    assert set(hist) <= {0.0, 0.25, 0.5, 0.75}
    assert sum(hist.values()) == 100
    for w in (0.0, 0.25, 0.5, 0.75):
        assert abs(hist.get(w, 0) - 25) <= 22, hist


def test_table1_histogram_mhigh_layout_matches():
    # The layout must not change the physics: same seed, same histogram.
    e_std = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    e_mh = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128, layout="m_high")
    h1 = omega_histogram(15, 7, 3, 4, runs=40, seed=3, engine=e_std)
    h2 = omega_histogram(15, 7, 3, 4, runs=40, seed=3, engine=e_mh)
    assert sum(h1.values()) == sum(h2.values()) == 40
    assert set(h2) <= {0.0, 0.25, 0.5, 0.75}


def test_fig2_norm_trace():
    tr = norm_deviation_trace(39, 7, 6, 6)
    # Report §IV.A: deviations at double round-off (their max: 2.4e-15).
    assert tr.max_deviation < 1e-13


def test_table1_scripted_chi2():
    """The scripted TABLE I harness: 400 shots, chi-squared vs uniform."""
    from quantumcomputer.utils.experiments import table1_experiment

    res = table1_experiment(
        runs=400, seed=11,
        engine=StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128),
    )
    assert res.passed, str(res)
    assert sum(res.counts.values()) == 400
    assert res.p_value > 0.001


def test_table1_detects_broken_distribution():
    """The harness must FAIL a biased simulator (sanity of the test itself):
    feed it a histogram far from uniform via a rigged engine."""
    from quantumcomputer.utils import experiments as ex

    class Rigged:
        layout = "standard"
        register = Register(L=3, M=4)

        def run_and_measure_index(self, circuit, key):
            return 16  # always the same index -> omega = 0 always

        def logical_index(self, idx):
            return idx

    res = ex.table1_experiment(runs=100, seed=0, engine=Rigged())
    assert not res.passed


def test_fig3_scaling_harness_runs():
    """FIG. 3 harness (Report §IV.C): returns timing rows over both axes;
    tiny ranges on CPU (xla backend) just to exercise the machinery."""
    from quantumcomputer.utils.experiments import fig3_scaling

    rows_L, rows_M = fig3_scaling(
        L_range=(3, 4), M_range=(5, 6), L_fixed=3, M_fixed=5, iters=1,
    )
    assert [(r[0], r[1]) for r in rows_L] == [(3, 5), (4, 5)]
    assert [(r[0], r[1]) for r in rows_M] == [(3, 5), (3, 6)]
    assert all(r[3] > 0 for r in rows_L + rows_M)
