"""chip_smoke.py on the CPU: phase selection, the result-line contract,
failure handling, and every phase's checks at small sizes (the script's
own sizes need the card)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_phase_selection():
    assert cs.select_phases(4) == ["sharded"]
    one = cs.select_phases(1)
    assert one == ["kernels", "full_register", "semiclassical", "complex128"]
    assert "sharded" not in one
    assert set(one) | {"sharded"} == set(cs.PHASES)


def test_result_line_format():
    devs = jax.devices()[:1]
    line = json.loads(cs.result_line(devs))
    assert line == {
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": 1},
    }


def test_failed_phase_stops_the_run():
    ran = []

    def phase(name, err):
        def fn():
            ran.append(name)
            return [cs.Check(name, err, 1e-6)]

        return name, fn

    lines = []
    ok = cs.run_phases([phase("a", 0.0), phase("b", 1.0), phase("c", 0.0)], out=lines.append)
    assert ok is False and ran == ["a", "b"]
    assert any("phase b FAILED" in s for s in lines)
    assert any("err 1.000e+00 tol 1.0e-06 FAIL" in s for s in lines)
    assert cs.run_phases([phase("d", 0.0)], out=lines.append) is True
    assert cs.run_phases([("empty", lambda: [])], out=lines.append) is False
    assert not cs.Check("nan", float("nan"), 1.0).ok


def test_exception_in_phase_propagates():
    def boom():
        raise RuntimeError("phase crashed")

    with pytest.raises(RuntimeError, match="phase crashed"):
        cs.run_phases([("boom", boom)], out=lambda s: None)


def test_main_without_gpu_exits_nonzero_with_no_result(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--chips", "4"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_closed_form_matches_reference_marginal():
    """period_marginal (bit-reversed frequency) vs the L-register marginal
    of the reference state, standard layout."""
    from quantumcomputer.sim import reference as ref

    C, a, L, M, r = 21, 2, 6, 5, 6
    p = np.abs(ref.shor_circuit(C, a, L, M)) ** 2
    marg = p.reshape(1 << L, 1 << M).sum(axis=1)  # logical L-part, LSB-first
    np.testing.assert_allclose(cs.period_marginal(L, r)[cs.bitrev_table(L)], marg, atol=1e-12)
    assert cs.multiplicative_order(a, C) == r


def test_prediction_matches_engine_measurement():
    """full_register_predictor picks the engine's own measured index."""
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    C, a, L, M, r = 21, 2, 7, 5, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    circ = shor_circuit_mhigh(C, a, L, M)
    predict = cs.full_register_predictor(C, a, L, M, r)
    for seed, draw in zip(range(6), cs.first_draws(range(6))):
        idx, margin = predict(draw)
        if margin < 1e-5:
            continue
        sub = jax.random.split(jax.random.PRNGKey(seed))[1]
        assert eng.logical_index(eng.run_and_measure_index(circ, sub)) == idx


def test_gate_class_checks_small():
    checks = cs.gate_class_checks(14, ("complex64", "complex32", "complex128"))
    assert len(checks) == 3 * len(cs.gate_classes(14))
    assert all(c.ok for c in checks), [c.line() for c in checks if not c.ok]


def test_sampler_checks_small():
    lines = []
    checks = cs.sampler_checks(17, 16, out=lines.append)
    assert all(c.ok for c in checks), [c.line() for c in checks]
    assert any("identical indices" in s for s in lines)


@pytest.mark.parametrize("dtype,tol", [("complex64", 1e-4), ("complex32", 1e-2)])
def test_full_register_checks_small(dtype, tol):
    checks = cs.full_register_checks([(21, 2, 6, 5, dtype, 6, (7, 3), tol)], out=lambda s: None)
    assert all(c.ok for c in checks), [c.line() for c in checks]


def test_semiclassical_checks_small():
    pred = cs._predictor()
    seed = next(s for s in range(32) if pred.predict_attempt(391, 3, 10, s)["factors"] == (23, 17))
    r = cs.multiplicative_order(3, 391)
    checks = cs.semiclassical_checks((391, 3, 10, 9, r, (23, 17), seed), out=lambda s: None, steps=False)
    assert all(c.ok for c in checks), [c.line() for c in checks]


def test_sharded_checks_small():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    lines = []
    checks = cs.sharded_checks((21, 2, 7, 5, 6, (7, 3), 4), out=lines.append)
    assert all(c.ok for c in checks), [c.line() for c in checks]
    assert any("shard bytes per card" in s for s in lines)
