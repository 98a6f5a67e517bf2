"""Device-derived memory model (utils/memory.py).

The budget is derived from the device's reported allocator pool.  These
tests fake `memory_stats()` to check the derivation, the error for an
accelerator that reports nothing, the CPU test budget, and the planner
predicate — and that the `-V` per-phase path in find_period degrades
gracefully when two state buffers do not fit.
"""

import jax
import jax.numpy as jnp
import pytest

from quantumcomputer.utils import memory


class _FakeDev:
    def __init__(self, platform="gpu", stats=None, raises=False):
        self.platform = platform
        self._stats = stats
        self._raises = raises

    def memory_stats(self):
        if self._raises:
            raise RuntimeError("backend does not expose stats")
        return self._stats


# What an H100 80GB HBM3 reports under JAX's default 75% allocator share.
H100_STATS = {"bytes_limit": 63763120128, "bytes_in_use": 0, "peak_bytes_in_use": 0}


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    memory._reset_cache_for_tests()
    monkeypatch.delenv("QC_HBM_BYTES", raising=False)
    yield
    memory._reset_cache_for_tests()


def test_env_override_wins(monkeypatch):
    monkeypatch.setenv("QC_HBM_BYTES", "123456789")
    assert memory.device_hbm_budget() == 123456789
    # env also beats an explicit device
    dev = _FakeDev(stats={"bytes_limit": 1 << 40})
    assert memory.device_hbm_budget(dev) == 123456789


def test_budget_scales_with_reported_pool():
    # A part reporting twice the pool gets twice the budget, so the
    # planner and bench sizing scale with the device.
    small = _FakeDev(stats={"bytes_limit": int(40e9)})
    big = _FakeDev(stats={"bytes_limit": int(80e9)})
    b_small = memory.device_hbm_budget(small)
    b_big = memory.device_hbm_budget(big)
    assert b_big == 2 * b_small
    assert b_small == int(int(40e9) * memory._USABLE_FRACTION)


def test_gpu_budget_from_bytes_limit():
    """A GPU's budget is its reported bytes_limit times the usable
    fraction — about 55 GiB on an H100, not a fixed small-device guess."""
    budget = memory.device_hbm_budget(_FakeDev(stats=H100_STATS))
    assert budget == int(H100_STATS["bytes_limit"] * memory._USABLE_FRACTION)
    assert budget > 50 * (1 << 30)


def test_error_when_no_stats():
    """An accelerator whose memory_stats() is empty is an error, not a
    silent fallback."""
    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.device_hbm_budget(_FakeDev(stats=None))
    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.device_hbm_budget(_FakeDev(stats={"bytes_in_use": 0}))


def test_error_when_stats_raise():
    with pytest.raises(RuntimeError, match="no memory stats"):
        memory.device_hbm_budget(_FakeDev(raises=True))


def test_cpu_host_uses_named_test_budget():
    # The CPU backend has no device memory of its own: the planner uses
    # the fixed, named CPU test budget.
    assert jax.devices()[0].platform == "cpu"
    assert memory.device_hbm_budget() == memory.CPU_TEST_BUDGET
    assert memory.device_hbm_budget(_FakeDev(platform="cpu", raises=True)) == memory.CPU_TEST_BUDGET


def test_two_state_predicate_tracks_budget(monkeypatch):
    from quantumcomputer.sim.engine import two_state_programs_fit

    monkeypatch.setenv("QC_HBM_BYTES", str(1 << 30))
    # 2 states * 2 planes * 2^n * itemsize <= 1 GiB  ->  n <= 26 at f32
    assert two_state_programs_fit(26, jnp.float32)
    assert not two_state_programs_fit(27, jnp.float32)
    # bf16 halves the bytes -> one more qubit
    assert two_state_programs_fit(27, jnp.bfloat16)


def test_bench_pick_n_scales(monkeypatch):
    import bench

    monkeypatch.setenv("QC_HBM_BYTES", str(int(14.5 * (1 << 30))))
    assert bench.pick_n() == 30  # 8 GiB state + headroom
    monkeypatch.setenv("QC_HBM_BYTES", str(int(29 * (1 << 30))))
    assert bench.pick_n() == 31  # capped by int32 indices
    monkeypatch.setenv("QC_HBM_BYTES", str(int(H100_STATS["bytes_limit"] * memory._USABLE_FRACTION)))
    assert bench.pick_n() == 31  # never past the index-width cap


def test_very_verbose_uses_folded_prefixes_at_ceiling(monkeypatch, capsys):
    """-V per-phase progress normally threads state-passing programs (two
    live state buffers); at the memory ceiling find_period must switch to
    reset-folded PREFIX programs (one state live, scalar outputs) and
    still print every phase banner (VERDICT r2, weak #4 / item 5)."""
    from quantumcomputer.algorithms.shor import find_period
    from quantumcomputer.sim.engine import Register, StateVectorEngine
    from quantumcomputer.utils import logging as qlog

    monkeypatch.setenv("QC_HBM_BYTES", "1")  # nothing fits out-of-place
    monkeypatch.setattr(qlog, "_verbose", True)
    monkeypatch.setattr(qlog, "_very_verbose", True)
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    runs = []
    orig = eng.run_norm
    monkeypatch.setattr(
        eng, "run_norm", lambda circ: runs.append(len(circ)) or orig(circ)
    )
    rec = find_period(eng, 15, 7, jax.random.PRNGKey(0))
    assert rec.period == 4
    # TWO folded prefixes: the final phase executes inside the folded
    # measurement program itself (a third run_norm would run the full
    # circuit twice back to back).
    assert runs == [3, 6]
    out = capsys.readouterr().out
    assert "reset-folded prefix programs" in out
    assert "inverse quantum Fourier transform" in out
