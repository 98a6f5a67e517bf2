"""bench.py row isolation: one failing metric must never erase the run's
other measurements.  A fault injected into one bench function must still
yield the single parseable JSON line with every other row real and the
fault recorded in row_errors.  The CPU has no published peak, so these
tests give it a stand-in entry; without one the bench refuses to run."""

import json
import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def _run_main(capsys):
    bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out  # the one-JSON-line contract holds
    return json.loads(out[0])


def test_unknown_device_kind_is_an_error():
    with pytest.raises(ValueError, match="no published memory-bandwidth peak"):
        bench.detect_bandwidth()


def test_fault_in_one_row_preserves_the_rest(capsys, monkeypatch):
    monkeypatch.setattr(bench, "pick_n", lambda: 16)  # keep CPU rows quick
    monkeypatch.setitem(bench.PEAK_HBM_GBPS, "cpu", 50.0)

    def boom():
        raise RuntimeError("injected fault")

    monkeypatch.setattr(bench, "bench_shor15", boom)
    rec = _run_main(capsys)
    # The faulted row: zeroed default + explicit marker, never fabricated.
    assert rec["shor15_wallclock_s"] == 0.0 and rec["shor15_ok"] is False
    assert "shor15" in rec["row_errors"]
    assert "injected fault" in rec["row_errors"]["shor15"]
    # The other rows that run on CPU are real.
    assert rec["value"] > 0  # gate throughput
    assert rec["dispatch_rtt_s"] > 0
    assert rec["metric"] == "gate_apps_per_sec_n16"
    # The derived ceiling string names the failed rows.
    assert "shor15" in rec["n30_status"]


def test_clean_run_has_empty_row_errors(capsys, monkeypatch):
    monkeypatch.setattr(bench, "pick_n", lambda: 16)
    monkeypatch.setitem(bench.PEAK_HBM_GBPS, "cpu", 50.0)
    rec = _run_main(capsys)
    assert rec["row_errors"] == {}
    assert rec["shor15_ok"] is True
    assert rec["value"] > 0
