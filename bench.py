"""North-star benchmark: gate applications/sec at large n vs HBM roofline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The reference publishes no throughput numbers (BASELINE.md), so the
baseline is the physical one: a dense single-qubit gate pass is
memory-bound — it must read and write the full state once (2 * 2^n * 8
bytes in complex64).  vs_baseline is the achieved fraction of the
device-memory roofline for the detected device kind (1.0 == speed of
light).  The peaks are published figures (PEAK_HBM_GBPS); a device kind
without one is an error.

Extras report the Shor N=15 end-to-end wall-clock (execute-only, compile
excluded) to anchor against the reference's "10s of seconds" scale.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register, StateVectorEngine

# Peak device-memory bandwidth (GB/s) per device_kind, as JAX reports it.
# Source: NVIDIA H100 data sheet (SXM5, 80 GB HBM3: 3.35 TB/s), at the
# card's full power limit; a card set below it may not sustain the peak.
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def detect_bandwidth() -> tuple[str, float]:
    """(device_kind, published peak GB/s); unknown kinds are an error."""
    kind = str(jax.devices()[0].device_kind)
    if kind not in PEAK_HBM_GBPS:
        raise ValueError(
            f"no published memory-bandwidth peak for device kind {kind!r}; "
            "add it to bench.PEAK_HBM_GBPS with its source"
        )
    return kind, PEAK_HBM_GBPS[kind]


def pick_n() -> int:
    """Largest n that runs on this device, derived from its memory budget
    (utils/memory.device_hbm_budget): reset-folded scalar-output programs
    (engine.run_norm) peak at about one complex64 state plus working
    headroom, so n satisfies 1.8 * (2 * 2^n * 4 B) <= budget — capped at
    n=31 (basis indices must fit int32 without x64; see
    tests/test_index_width.py)."""
    from quantumcomputer.utils.memory import device_hbm_budget

    budget = device_hbm_budget()
    n = 20
    while n < 31 and int(1.8 * 2 * (1 << (n + 1)) * 4) <= budget:
        n += 1
    return n


# Headline gate-mix definition, FROZEN for cross-round comparability (any
# change bumps the version and the metric name).  v2 (since round 2): blocks
# of 17 distinct-qubit RY rotations (13 lane/row + 4 axis-class targets)
# separated by a camodc_high(C=8191, a=3, M=13) oracle pass; the headline is
# the slope between 1-block and 3-block circuits, i.e. 18 gates' wall-clock
# with dispatch overhead cancelled.
GATE_MIX_VERSION = 2


def bench_gate_throughput(n: int, reps: int = 5):
    """Per-gate wall-clock via a two-block-size slope.

    Timing uses reset-folded scalar-output programs (one dispatch + one
    scalar fetch per run; see profiling.time_circuit_folded), and the
    small/large block slope cancels the fixed dispatch overhead.
    Gate mix: RY rotations (not self-inverse, nothing foldable) across
    lane-local, mid, and high target strides.
    """
    from quantumcomputer.utils.profiling import time_circuit_folded as time_circuit

    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    # 17 DISTINCT qubits per block (13 low + 4 high strides), blocks
    # separated by a modular-multiply gate, itself a production workload.
    # small=1 vs big=3 blocks gives the slope.
    qubits = list(range(13)) + [n - 4, n - 3, n - 2, n - 1]
    sep = cir.Gate("camodc_high", (0,), meta=(8191, 3, 13))

    def blocks(k: int):
        gs = []
        for b in range(k):
            gs.extend(cir.RY(q, 0.1 + 0.013 * (q + b)) for q in qubits)
            gs.append(sep)
        return tuple(gs)

    small, big = 1, 3
    t_small = time_circuit(eng, blocks(small), iters=reps)
    t_big = time_circuit(eng, blocks(big), iters=reps)
    n_gates = (big - small) * (len(qubits) + 1)
    per_gate = max((t_big - t_small) / n_gates, 1e-12)
    return 1.0 / per_gate, n_gates, per_gate


def bench_full_shor_circuit(n: int = 28, layout: str = "m_high", dtype=jnp.complex64):
    """Wall-clock of ONE full period-finding circuit at scale: C=8191 (the
    largest prime below 2^13), M=13, L=n-13 — the flagship workload.  The
    reference's practical ceiling was ~N=39 on 12 qubits in minutes
    (BASELINE.md); this is the same circuit family at 2^28 amplitudes.
    layout="m_high" puts the work register in the top physical bits: the
    oracle becomes a major-axis row gather and all H/iQFT butterflies land
    on low physical qubits."""
    from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_mhigh
    from quantumcomputer.utils.profiling import time_circuit_folded as time_circuit

    C, a, M = 8191, 3, 13
    L = n - M
    eng = StateVectorEngine(Register(L=L, M=M), dtype=dtype, layout=layout)
    circ = shor_circuit_mhigh(C, a, L, M) if layout == "m_high" else shor_circuit(C, a, L, M)
    full = time_circuit(eng, circ, iters=3)
    # The timed quantity is dispatch + circuit + one scalar fetch; the
    # empty-circuit run measures that fixed overhead so the compute-only
    # number can be reported alongside.
    barrier = time_circuit(eng, (), iters=3)
    return full, max(full - barrier, 0.0), len(circ)


def bench_shor15(seed: int = 0):
    """Shor N=15 wall-clock, execute-only (compile amortized out)."""
    from quantumcomputer.algorithms.shor import shors_algorithm

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    # Warm-up run compiles the circuit + measurement programs.
    shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=seed, engine=eng)
    t0 = time.perf_counter()
    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=seed + 1, engine=eng)
    elapsed = time.perf_counter() - t0
    ok = bool(res.ok and res.factors and res.factors[0] * res.factors[1] == 15)
    return elapsed, ok


def bench_stream_bandwidth(n: int, reps: int = 5):
    """Single-pass streaming bandwidth: per-gate slope — each gate is one
    read+write of the state.  Runs at min(n, 29): the gate passes are
    out-of-place, so this benchmark needs two state buffers live."""
    from quantumcomputer.utils.profiling import time_circuit_folded as time_circuit

    n = min(n, 29)
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64, fuse=False)
    qubits = [0, 7, n // 2, n - 1]

    def block(k: int):
        return tuple(cir.RY(qubits[i % len(qubits)], 0.1 + 0.017 * i) for i in range(k))

    t_small = time_circuit(eng, block(2), iters=reps)
    t_big = time_circuit(eng, block(10), iters=reps)
    per_pass = max((t_big - t_small) / 8, 1e-12)
    return 2 * (1 << n) * 8 / per_pass / 1e9  # GB/s


def bench_semiclassical(M: int = 28, reps: int = 3, dtype=jnp.complex64,
                        structured=False, L_pair=(2, 10)):
    """Per-step wall-clock of the semiclassical engine at scale: C ~ 2^M
    (a 2^M-amplitude work state — the implicit-control form), via the
    slope between a small-L and a large-L attempt so the fixed
    dispatch overhead cancels.  One step = one controlled modular
    multiply + deferred-phase rotation + measure/collapse/reset over the
    full state: the production semiclassical workload.

    structured=False is the production default (compile-once gather
    programs); structured=True times the stride-permutation oracle so both
    paths are tracked."""
    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    C = (1 << M) - 3  # gcd(7, 2^M-3) == 1 for M in {28, 30}
    key = jax.random.PRNGKey(0)

    def attempt_wall(L: int) -> float:
        run_semiclassical(C, 7, L, M, key, dtype, structured=structured)  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run_semiclassical(C, 7, L, M, key, dtype, structured=structured)
            best = min(best, time.perf_counter() - t0)
        return best

    L0, L1 = L_pair
    t0_, t1_ = attempt_wall(L0), attempt_wall(L1)
    return max((t1_ - t0_) / (L1 - L0), 1e-12), t1_


def bench_copy_floor(n: int, reps: int = 5):
    """Identity-copy control for the streaming-roofline claim: a jitted
    copy of the (2, 2^n) f32 planar state, one read and one write with
    zero compute — the denominator for stream_vs_copy_frac."""
    import statistics

    n = min(n, 30)
    x = jnp.ones((2, 1 << n), jnp.float32)
    copy = jax.jit(lambda v: v.copy())
    jax.block_until_ready(copy(x))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(copy(x))
        ts.append(time.perf_counter() - t0)
    return 2 * x.nbytes / statistics.median(ts) / 1e9  # read + write, GB/s


def bench_dispatch_rtt(reps: int = 10):
    """Round-trip of a trivial jitted scalar program: dispatch + transfer,
    zero compute.  Headline small-circuit rows (shor15) are
    dispatch-dominated; this isolates the host's contribution."""
    f = jax.jit(lambda x: x + 1.0)
    f(jnp.float32(0)).block_until_ready()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f(jnp.float32(1)).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def _row(errors: dict, key: str, default, fn, *args, **kw):
    """Row isolation: one exception in one metric must never erase the
    run's other measurements.  On failure the row gets its DEFAULT (a
    zero, never a fabricated measurement) and a truncated error marker
    lands in the JSON's row_errors map."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — the record survives any row
        errors[key] = f"{type(e).__name__}: {e}"[:300]
        return default


# Rows that need a state of this many qubits or more run only when the
# device's budget (pick_n) reaches it.
LARGE_N = 28


def main():
    from quantumcomputer.utils.compile_cache import enable as _cc

    _cc()
    kind, bw_gbps = detect_bandwidth()
    n = pick_n()
    large = n >= LARGE_N
    errors: dict = {}

    gate_apps_per_sec, n_gates, best_s = _row(
        errors, "gate_throughput", (0.0, 0, 0.0), bench_gate_throughput, n,
    )

    # Baseline: the memory roofline for one gate per pass — one dense 1q
    # gate pass must read+write the complex64 state (2 * 2^n * 8 bytes).
    bytes_per_gate = 2 * (1 << n) * 8
    roofline_gate_apps = bw_gbps * 1e9 / bytes_per_gate
    frac = gate_apps_per_sec / roofline_gate_apps

    stream_gbps = (
        _row(errors, "stream_bandwidth", 0.0, bench_stream_bandwidth, n)
        if large else 0.0
    )
    shor_s, shor_ok = _row(errors, "shor15", (0.0, False), bench_shor15)
    # Flagship circuit at n=28, 29 and 30.
    full_s, full_compute_s, full_gates = (
        _row(errors, "full_n28", (0.0, 0.0, 0), bench_full_shor_circuit, 28)
        if large else (0.0, 0.0, 0)
    )
    full29_s, full29_compute_s, _ = (
        _row(errors, "full_n29", (0.0, 0.0, 0), bench_full_shor_circuit, 29)
        if large else (0.0, 0.0, 0)
    )
    full30_s, full30_compute_s, _ = (
        _row(errors, "full_n30", (0.0, 0.0, 0), bench_full_shor_circuit, 30)
        if large else (0.0, 0.0, 0)
    )
    # complex32 (bf16-storage) throughput mode at the ceilings: half the
    # HBM traffic per pass, ~2e-4 amplitude error envelope (test_complex32).
    c32_30_s, c32_30_compute_s, _ = (
        _row(errors, "full_n30_c32", (0.0, 0.0, 0),
             bench_full_shor_circuit, 30, dtype="complex32")
        if large else (0.0, 0.0, 0)
    )
    c32_31_s, c32_31_compute_s, _ = (
        _row(errors, "full_n31_c32", (0.0, 0.0, 0),
             bench_full_shor_circuit, 31, dtype="complex32")
        if large else (0.0, 0.0, 0)
    )
    # Semiclassical per-step rows: the m28 c64 default (gather) path, the
    # m28 c64 structured oracle, m28 c32, and the m30 c32 30-bit regime.
    sc_step_s, sc_attempt10_s = (
        _row(errors, "semiclassical_m28", (0.0, 0.0), bench_semiclassical, 28)
        if large else (0.0, 0.0)
    )
    sc_structured_step_s, _ = (
        _row(errors, "semiclassical_m28_structured", (0.0, 0.0),
             bench_semiclassical, 28, structured=True)
        if large else (0.0, 0.0)
    )
    sc28c32_step_s, _ = (
        _row(errors, "semiclassical_m28_c32", (0.0, 0.0),
             bench_semiclassical, 28, dtype="complex32")
        if large else (0.0, 0.0)
    )
    sc30_step_s, _ = (
        _row(errors, "semiclassical_m30_c32", (0.0, 0.0),
             bench_semiclassical, 30, reps=2, dtype="complex32", L_pair=(2, 6))
        if large else (0.0, 0.0)
    )
    copy_gbps = (
        _row(errors, "copy_floor", 0.0, bench_copy_floor, n) if large else 0.0
    )
    dispatch_rtt_s = _row(errors, "dispatch_rtt", 0.0, bench_dispatch_rtt)
    # Ceiling status derived from this run: n comes from pick_n's walk
    # over the detected device's memory budget.
    ceiling = (
        f"measured this run on {kind}: scalar-output f32 programs run "
        f"n={n} (pick_n from the device memory budget)"
        + (f"; row_errors={sorted(errors)}" if errors else "")
    )

    print(
        json.dumps(
            {
                "metric": f"gate_apps_per_sec_n{n}",
                "gate_mix_version": GATE_MIX_VERSION,
                "value": round(gate_apps_per_sec, 3),
                "unit": "gate applications/s (dense 1q mix, complex64)",
                "vs_baseline": round(frac, 4),
                "baseline": f"HBM roofline for one gate per pass: {roofline_gate_apps:.2f} gates/s @ {bw_gbps:.0f} GB/s ({kind})",
                "stream_gbps_single_pass": round(stream_gbps, 1),
                "stream_roofline_frac": round(stream_gbps / bw_gbps, 4),
                "shor15_wallclock_s": round(shor_s, 4),
                "shor15_ok": shor_ok,
                "shor8191_circuit_n28_s": round(full_s, 4),
                "shor8191_circuit_n28_compute_s": round(full_compute_s, 4),
                "shor8191_circuit_n29_s": round(full29_s, 4),
                "shor8191_circuit_n29_compute_s": round(full29_compute_s, 4),
                "shor8191_circuit_n30_s": round(full30_s, 4),
                "shor8191_circuit_n30_compute_s": round(full30_compute_s, 4),
                "shor8191_circuit_n30_c32_s": round(c32_30_s, 4),
                "shor8191_circuit_n30_c32_compute_s": round(c32_30_compute_s, 4),
                "shor8191_circuit_n31_c32_s": round(c32_31_s, 4),
                "shor8191_circuit_n31_c32_compute_s": round(c32_31_compute_s, 4),
                "shor8191_circuit_gates": full_gates,
                "semiclassical_step_m28_s": round(sc_step_s, 4),
                "semiclassical_step_m28_structured_s": round(sc_structured_step_s, 4),
                "semiclassical_step_m28_c32_s": round(sc28c32_step_s, 4),
                "semiclassical_step_m30_c32_s": round(sc30_step_s, 4),
                "semiclassical_attempt_L10_m28_s": round(sc_attempt10_s, 4),
                "copy_floor_gbps": round(copy_gbps, 1),
                "stream_vs_copy_frac": round(stream_gbps / copy_gbps, 4) if copy_gbps else 0.0,
                "dispatch_rtt_s": round(dispatch_rtt_s, 5),
                "n_qubits": n,
                "n30_status": ceiling,
                "row_errors": errors,
            }
        )
    )


if __name__ == "__main__":
    main()
