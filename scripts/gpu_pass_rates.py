"""Pass rates of the XLA path on one GPU, each beside a copy timed in the
same process.

    python scripts/gpu_pass_rates.py [--n 30] [--out chiprun_out/gpu_pass_rates.json]

Rows (one JSON object each, also written to --out):
  copy / negate       a read and a write of the n-qubit complex64 state;
  gate classes        dense 1q (low/mid/high stride), diag, dense 2q,
                      camodc_high gather oracle, iqft_stage;
  sampler             block sums, one two-level draw, 1024 draws, and the
                      flat cumsum draw for contrast;
  semiclassical       one M=28 complex64 step, structured oracle vs gather
                      (slope between L=1 and L=4 attempts).

Times are host clock around block_until_ready, median of --reps runs after
a warm-up.  Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROWS: list = []


def emit(row: dict) -> None:
    ROWS.append(row)
    print(json.dumps(row), flush=True)


def timed(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def row(name: str, fn, *args, nbytes: int, reps: int, copy_s=None) -> float:
    try:
        s = timed(fn, *args, reps=reps)
    except Exception as e:  # noqa: BLE001 - one failed row must not hide the rest
        emit({"row": name, "error": f"{type(e).__name__}: {e}"[:400]})
        return float("nan")
    out = {"row": name, "seconds": s, "bytes": nbytes, "GBps": nbytes / s / 1e9}
    if copy_s:
        out["copy_share"] = copy_s / s
    emit(out)
    return s


def gate_rows(n: int, reps: int) -> None:
    from quantumcomputer.ops import gates as xops

    dim = 1 << n
    z = jax.jit(lambda: jnp.full((dim,), 2.0 ** (-n / 2), jnp.complex64))()
    state_bytes = dim * 8
    rw = 2 * state_bytes
    copy_s = row("copy", jax.jit(lambda x: x.copy()), z, nbytes=rw, reps=reps)
    row("negate", jax.jit(lambda x: -x), z, nbytes=rw, reps=reps)
    u = jnp.asarray(np.array([[0.6, 0.8], [0.8, -0.6]], np.complex64))
    for q in (0, 15, n - 1):
        row(f"1q_q{q}", jax.jit(lambda x, q=q: xops.apply_1q(x, u, q)), z,
            nbytes=rw, reps=reps, copy_s=copy_s)
    d2 = jnp.asarray(np.exp(1j * np.array([0.0, 0.3])).astype(np.complex64))
    row("diag_q15", jax.jit(lambda x: xops.apply_diag_1q(x, d2, 15)), z,
        nbytes=rw, reps=reps, copy_s=copy_s)
    u4 = jnp.asarray(np.linalg.qr(np.random.default_rng(0).standard_normal((4, 4)))[0].astype(np.complex64))
    for hi, lo in ((n - 1, 0), (20, 10)):
        row(f"2q_{hi}_{lo}", jax.jit(lambda x, hi=hi, lo=lo: xops.apply_2q(x, u4, hi, lo)), z,
            nbytes=rw, reps=reps, copy_s=copy_s)
    # Flagship oracle: C=8191, M=13 work register in the top bits (m_high).
    row("camodc_high_C8191", jax.jit(lambda x: xops.apply_camodc_high(x, 8191, 3, 0, 13)), z,
        nbytes=rw, reps=reps, copy_s=copy_s)
    row(f"iqft_stage_l{n - 2}", jax.jit(lambda x: xops.apply_iqft_stage(x, n - 2, 0)), z,
        nbytes=rw, reps=reps, copy_s=copy_s)
    del z


def sampler_rows(n: int, reps: int) -> None:
    from quantumcomputer.ops import measure

    dim = 1 << n
    re = jax.jit(lambda: jnp.full((dim,), 2.0 ** (-n / 2), jnp.float32))()
    im = jax.jit(lambda: jnp.zeros((dim,), jnp.float32))()
    nbytes = 2 * dim * 4
    row("blocksum_xla", jax.jit(measure.block_prob_sums_planes), re, im, nbytes=nbytes, reps=reps)
    r = jnp.float32(0.37)
    row("sample_index_xla", jax.jit(measure.sample_index_planes), re, im, r, nbytes=nbytes, reps=reps)
    rs = jax.random.uniform(jax.random.PRNGKey(0), (1024,), jnp.float32)
    row("sample_1024_shots_xla", jax.jit(measure.sample_indices_planes), re, im, rs, nbytes=nbytes, reps=reps)
    row("flat_cumsum_draw", jax.jit(measure.flat_sample_indices_planes), re, im, r, nbytes=nbytes, reps=reps)


def semiclassical_rows() -> None:
    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    C, a, M = 255866087, 2, 28
    key = jax.random.PRNGKey(0)
    for structured in (True, False):
        try:
            walls = {}
            for L in (1, 4):
                run_semiclassical(C, a, L, M, key, jnp.complex64, structured=structured)
                ts = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    run_semiclassical(C, a, L, M, key, jnp.complex64, structured=structured)
                    ts.append(time.perf_counter() - t0)
                walls[L] = min(ts)
            emit({"row": f"semiclassical_m28_step_structured={structured}",
                  "step_seconds": (walls[4] - walls[1]) / 3, "attempt_L4_seconds": walls[4]})
        except Exception as e:  # noqa: BLE001
            emit({"row": f"semiclassical_m28_structured={structured}", "error": f"{type(e).__name__}: {e}"[:600]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/gpu_pass_rates.json")
    ap.add_argument("--skip", default="", help="comma list of: gates,sampler,semiclassical")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found (platform {dev.platform})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    emit({"row": "device", "nvidia_smi": smi, "kind": dev.device_kind, "jax": jax.__version__,
          "bytes_limit": (dev.memory_stats() or {}).get("bytes_limit"),
          "XLA_FLAGS": os.environ.get("XLA_FLAGS", "")})
    skip = set(filter(None, args.skip.split(",")))
    if "gates" not in skip:
        gate_rows(args.n, args.reps)
    if "sampler" not in skip:
        sampler_rows(args.n, args.reps)
    if "semiclassical" not in skip:
        semiclassical_rows()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ROWS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
