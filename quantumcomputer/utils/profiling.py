"""Profiling & observability: the north-star perf counters.

The reference's tracing is one wall-clock around the whole algorithm
(clock_gettime, qc_shor.c:1007-1013) plus per-gate-group prints under -V.
Here: analytic per-gate memory-traffic accounting (bytes moved per gate
pass), roofline projection, wall-clock timing that ends in a fetched
scalar, and a jax.profiler trace wrapper.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax

from quantumcomputer.models.circuit import Circuit
from quantumcomputer.sim import statevec as sv


@dataclass
class GateCost:
    gate: str
    qubits: Tuple[int, ...]
    bytes_moved: int  # HBM traffic of one fused pass (read + write)


def bytes_per_state(n: int, real_dtype_bytes: int = 4) -> int:
    """Planar state footprint: 2 planes x 2^n x itemsize."""
    return 2 * (1 << n) * real_dtype_bytes


def circuit_cost(circuit: Circuit, n: int, real_dtype_bytes: int = 4) -> List[GateCost]:
    """Analytic HBM traffic per gate: every dense/diagonal/permutation pass
    reads and writes the full state once (the fused-kernel design goal).
    Gates that only touch the bit-1 half (none currently) would halve this."""
    sb = bytes_per_state(n, real_dtype_bytes)
    return [GateCost(g.name, g.qubits, 2 * sb) for g in circuit]


def roofline_seconds(circuit: Circuit, n: int, hbm_gbps: float, real_dtype_bytes: int = 4) -> float:
    """Lower bound on circuit wall-clock from HBM bandwidth alone."""
    total = sum(c.bytes_moved for c in circuit_cost(circuit, n, real_dtype_bytes))
    return total / (hbm_gbps * 1e9)


_jitted_norm = jax.jit(sv.norm)


def force_completion(state: jax.Array) -> float:
    """Execution barrier that also checks the result: fetch the state's
    norm (one jitted reduction) to the host."""
    return float(_jitted_norm(state))


def time_circuit(engine, circuit: Circuit, iters: int = 3, state: Optional[jax.Array] = None) -> float:
    """Best-of-iters wall-clock of one compiled circuit execution, with a
    host round-trip barrier.  The barrier adds one reduction pass + RTT;
    subtract a measured empty baseline for precise per-gate numbers
    (see bench.py's two-block-size slope method).

    A caller-supplied `state` is DONATED to the first engine.run (the
    engine's standard semantics) — it is invalid afterwards; pass a copy
    if you still need it."""
    if state is None:
        state = engine.initial_state()
    state = engine.run(circuit, state)
    force_completion(state)  # compile + warm
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        state = engine.run(circuit, state)
        force_completion(state)
        best = min(best, time.perf_counter() - t0)
    return best


def time_circuit_folded(engine, circuit: Circuit, iters: int = 3) -> float:
    """Best-of-iters wall-clock of one reset-folded circuit program
    (engine.run_norm): ONE dispatch whose only output is the norm scalar,
    so no state-sized buffer crosses the program boundary — the timing
    path that works at the single-device memory ceiling."""
    engine.run_norm(circuit)  # compile + warm
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.run_norm(circuit)
        best = min(best, time.perf_counter() - t0)
    return best


@dataclass
class PhaseTiming:
    label: str
    n_gates: int
    seconds: float


def phase_profile(engine, phases, iters: int = 3) -> List[PhaseTiming]:
    """Wall-clock breakdown of a circuit by named phase — the quantitative
    twin of the -V progress surface (e.g. H layer / oracle ladder / iQFT).

    `phases` is a sequence of (label, gates).  Cumulative prefixes are
    timed and differenced, so the fixed barrier/RTT overhead cancels and
    each number is the MARGINAL cost of that phase on the engine's real
    execution path (fusion across phase boundaries is preserved)."""
    base = time_circuit(engine, (), iters=iters)
    out: List[PhaseTiming] = []
    prefix: list = []
    prev = base
    for label, gates in phases:
        gates = tuple(gates)  # before extend: a one-shot iterable would be spent
        prefix.extend(gates)
        t = time_circuit(engine, tuple(prefix), iters=iters)
        out.append(PhaseTiming(label, len(gates), max(t - prev, 0.0)))
        prev = t
    return out


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace wrapper (view with TensorBoard / xprof).

    Start failures (unwritable path, a trace already active) degrade to
    running the body untraced — but LOUDLY, via a logged warning: a
    silently empty trace directory is worse than no wrapper."""
    from quantumcomputer.utils.logging import get_logger

    try:
        jax.profiler.start_trace(path)
        started = True
    except Exception as e:
        get_logger("profiling").warning("jax.profiler.start_trace(%r) failed: %s — body runs untraced", path, e)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:
                get_logger("profiling").warning("jax.profiler.stop_trace failed: %s", e)


@dataclass
class NormTrace:
    """Probability-conservation regression (Report §IV.A / FIG. 2):
    per-gate norm deviations from 1.0."""

    deviations: List[float]

    @property
    def max_deviation(self) -> float:
        return max((abs(d) for d in self.deviations), default=0.0)

    def to_dict(self) -> dict:
        return {"max_deviation": self.max_deviation, "deviations": self.deviations}


def norm_trace(engine, circuit: Circuit) -> NormTrace:
    """Run with per-gate norm tracking (the FIG. 2 experiment)."""
    _, norms = engine.run_with_norms(circuit)
    import numpy as np

    return NormTrace(deviations=[float(v - 1.0) for v in np.asarray(norms)])


# ---- collective accounting (mesh programs) -------------------------

_COLLECTIVE_KINDS = (
    "collective_permute",
    "all_to_all",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
)

_MLIR_ITEMSIZE = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "i64": 8, "ui64": 8, "i32": 4, "ui32": 4,
    "i16": 2, "ui16": 2, "i8": 1, "ui8": 1, "i1": 1,
    "complex<f32>": 8, "complex<f64>": 16,
}


@dataclass
class CollectiveOp:
    """One collective in a lowered (StableHLO) mesh program."""

    kind: str            # e.g. "collective_permute"
    shape: Tuple[int, ...]
    dtype: str           # MLIR element type, e.g. "bf16"

    @property
    def bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * _MLIR_ITEMSIZE.get(self.dtype, 4)


def collective_stats(stablehlo_text: str) -> List[CollectiveOp]:
    """Parse a lowered mesh program (``jax.jit(fn).lower(...).as_text()``)
    into its collectives — one entry per OPERAND tensor (pytree collectives
    like plane-pair ppermutes yield one entry per plane).

    This is the static collective-volume ledger the mesh design is tuned against
    (packed oracle exchanges, plane-pair bf16 collectives, ladder-fusion
    gating): assert on it in tests, or diff it across layouts when tuning.
    Parse the LOWERED StableHLO, not compiled HLO — XLA:CPU promotes bf16
    collectives to f32 (a platform artifact that would skew byte counts)."""
    import re as _re

    ops: List[CollectiveOp] = []
    name = _re.compile(r'"stablehlo\.(' + "|".join(_COLLECTIVE_KINDS) + r')"')
    # The op's trailing function signature `: (operand types) -> results`.
    # Attribute dicts also contain `: tensor<...>` (dense attrs) but never
    # `: (`, and region bodies print ops in pretty form (no parenthesized
    # signature), so the first `: (` after the op name is the right one.
    sig = _re.compile(r":\s*\(([^)]*)\)\s*->")
    ten = _re.compile(r"tensor<((?:\d+x)*)((?:complex<[^>]+>)|[a-z][a-z0-9]*)>")
    for m in name.finditer(stablehlo_text):
        s = sig.search(stablehlo_text, m.end())
        if s is None:
            continue
        for t in ten.finditer(s.group(1)):
            dims = tuple(int(x) for x in t.group(1).split("x") if x)
            ops.append(CollectiveOp(m.group(1), dims, t.group(2)))
    return ops


def collective_bytes(stablehlo_text: str, kind: Optional[str] = None) -> int:
    """Total bytes crossing the mesh in one program execution (per device,
    counting each collective's operand once), optionally for one op kind."""
    return sum(o.bytes for o in collective_stats(stablehlo_text) if kind is None or o.kind == kind)


def mesh_collective_report(engine, circuit: Circuit) -> dict:
    """Static collective traffic of one `engine.run(circuit)` execution, per
    device: ``{kind: {"count", "bytes"}, "total_bytes": N}``.

    Lowers the sharded program ABSTRACTLY (no device execution, no state
    allocation — safe at any n) and parses the StableHLO with
    `collective_stats`.  Use it to compare layouts/dtypes/fusion settings
    before paying a compile: e.g. complex32 halves `total_bytes` vs
    complex64, and the packed m_high oracle ships ~1/D of the rotation
    fallback's rows.  Mesh engines only (single-chip programs have no
    collectives)."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        raise ValueError("mesh_collective_report needs a sharded engine (no mesh found)")
    from jax.sharding import NamedSharding, PartitionSpec

    n = engine.register.n
    aval = jax.ShapeDtypeStruct(
        (2, 1 << n), engine.real_dtype,
        sharding=NamedSharding(mesh, PartitionSpec(None, mesh.axis_names[0])),
    )
    txt = engine._compiled_run(circuit).lower(aval).as_text()
    report: dict = {}
    total = 0
    for op in collective_stats(txt):
        ent = report.setdefault(op.kind, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += op.bytes
        total += op.bytes
    report["total_bytes"] = total
    return report
