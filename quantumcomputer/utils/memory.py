"""Device memory model: how much device memory a compiled program may claim.

The budget comes from the device's own report (`memory_stats()
["bytes_limit"]` — the XLA allocator's pool, already net of the runtime's
reservations) times a usable fraction.  An accelerator that reports no
limit is an error: planning against a guessed size would either refuse
programs that fit or let programs that do not fit reach the allocator.

The CPU backend has no device memory of its own (its stats, where any,
describe host RAM).  There the planner uses CPU_TEST_BUDGET, a fixed
budget that keeps its decisions deterministic and testable.

The reference has no memory model at all — it mallocs two state vectors
and hopes (qc_shor.c:1316-1321, ALLOC_CHECK never aborts); here the budget
gates which program forms (one-state vs two-state) a run may use.
"""

from __future__ import annotations

import os
from typing import Optional

# Planner budget on the CPU backend (tests and host runs): a fixed size,
# independent of the machine, so planner decisions are reproducible.
CPU_TEST_BUDGET = int(14.5 * (1 << 30))

# Fraction of the allocator pool a single program may plan to occupy:
# headroom for the program's own temporaries (collective buffers,
# donation copies, fusion scratch).
_USABLE_FRACTION = 0.92

_cached: Optional[int] = None


def device_hbm_budget(device=None) -> int:
    """Usable per-device memory budget in bytes for program planning.

    Order of precedence: QC_HBM_BYTES env override (testing / unusual
    deployments), CPU_TEST_BUDGET on the CPU backend, then the device's
    memory_stats()["bytes_limit"] scaled by the usable fraction."""
    global _cached
    env = os.environ.get("QC_HBM_BYTES")
    if env:
        try:
            val = int(env)
        except ValueError:
            val = -1
        if val > 0:
            return val
        # Malformed or non-positive: ignore rather than raising an
        # uncontextualized ValueError (or a zero budget that fails every
        # fits() check) from deep inside program planning.
        from quantumcomputer.utils.logging import get_logger

        get_logger("memory").warning(
            "ignoring invalid QC_HBM_BYTES=%r (want a positive byte count)", env
        )
    if device is None and _cached is not None:
        return _cached
    limit = _query_bytes_limit(device)
    budget = CPU_TEST_BUDGET if limit is None else int(limit * _USABLE_FRACTION)
    if device is None:
        _cached = budget
    return budget


def _query_bytes_limit(device=None) -> Optional[int]:
    """The device's allocator limit in bytes, or None on the CPU backend.
    Raises RuntimeError for an accelerator that reports no limit."""
    import jax

    dev = device if device is not None else jax.local_devices()[0]
    if getattr(dev, "platform", None) == "cpu":
        return None
    try:
        stats = dev.memory_stats()
    except Exception as e:  # noqa: BLE001 - re-raised with the device named
        raise RuntimeError(f"device {dev} reports no memory stats: {e}") from e
    limit = (stats or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {dev} reports no memory limit (memory_stats() = {stats!r}); "
            "set QC_HBM_BYTES to plan against a known budget"
        )
    return int(limit)


def _reset_cache_for_tests() -> None:
    global _cached
    _cached = None
