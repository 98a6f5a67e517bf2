#!/usr/bin/env python3
"""Smoke test of the simulator on one GPU (or four, with --chips 4).

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --chips 4  # the sharded phase on four GPUs, alone

Phases (one process, run in order; any failure exits non-zero):

  1. kernels        every XLA gate class at n=24 vs sim/reference.py in
                    complex64 and complex32; the two-level sampler vs f64
                    NumPy block sums and a flat scan at n=26, and its time
                    at n=30;
  2. full_register  factorizations through the CLI (cli.main) at n=30 and
                    n=31 (complex64, complex32), each after comparing the
                    L-register marginal, reduced on the device, with the
                    closed form of period finding;
  3. semiclassical  the 28-bit factorization through the CLI, its bits
                    against the exact replay (scripts/predict_semiclassical),
                    and one M=28 step on each oracle path;
  4. complex128     every gate class at n=24 in complex128 vs the reference.

--chips 4 runs only: the sharded n=32 factorization through the CLI, the
n=31 circuit sharded and on one card (marginals compared with each other
and with the closed form), and each card's shard bytes.

Every check prints its measured error beside its tolerance.  The last line
is one JSON object {"ok": true, "device": {...}}; it is printed only when
every phase passed.  Without a GPU the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (C, a, L, M, dtype, period, factors, TV tolerance of the L marginal):
# f32 accumulation for complex64, bf16 storage for complex32.
FULL_REGISTER_CASES = [
    (8187, 13, 17, 13, "complex64", 62, (2729, 3), 1e-4),
    (8189, 2, 18, 13, "complex64", 774, (431, 19), 1e-4),
    (8189, 2, 18, 13, "complex32", 774, (431, 19), 1e-2),
]
# 28-bit semiclassical factorization; the seed's measured bits are
# predicted exactly by scripts/predict_semiclassical.py (draw margin 0.048).
SEMICLASSICAL_CASE = (255866087, 2, 44, 28, 1305276, (16073, 15919), 12)
SHARDED_CASE = (8189, 2, 19, 13, 774, (431, 19), 4)  # n=32 on 4 cards

GATE_N = 24
SAMPLER_PARITY_N = 26
SAMPLER_TIMING_N = 30
# Tolerances: the CPU suite's own (tests/test_circuit_parity.py,
# tests/test_complex32.py); complex32 is relative to the largest amplitude.
TOL = {"complex64": 5e-6, "complex32": 1e-2, "complex128": 1e-12}


# -- reporting --------------------------------------------------------------------


class Check:
    def __init__(self, label: str, err: float, tol: float):
        self.label, self.err, self.tol = label, float(err), float(tol)

    @property
    def ok(self) -> bool:
        return self.err <= self.tol  # NaN fails

    def line(self) -> str:
        return f"  {self.label}: err {self.err:.3e} tol {self.tol:.1e} {'ok' if self.ok else 'FAIL'}"


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def select_phases(chips: int) -> list:
    """Phase names, in run order, for the card count."""
    if chips == 4:
        return ["sharded"]
    return ["kernels", "full_register", "semiclassical", "complex128"]


def run_phases(phases, out=print) -> bool:
    """Run (name, fn) phases in order; fn returns a list of Checks.  Stops
    at the first failed phase; exceptions propagate."""
    for name, fn in phases:
        t0 = time.perf_counter()
        checks = fn()
        out(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        for c in checks:
            out(c.line())
        if not checks or not all(c.ok for c in checks):
            out(f"phase {name} FAILED")
            return False
    return True


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def _timed(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# -- closed forms and predictions (host, float64) -----------------------------------------


def bitrev_table(L: int):
    import numpy as np

    x = np.arange(1 << L, dtype=np.int64)
    out = np.zeros_like(x)
    for b in range(L):
        out |= ((x >> b) & 1) << (L - 1 - b)
    return out


def _counts(L: int, r: int) -> dict:
    """N_s = #{k < 2^L : k = s mod r} -> how many s share it."""
    Q = 1 << L
    counts: dict = {}
    for N in ((Q - 1 - s) // r + 1 for s in range(r)):
        counts[N] = counts.get(N, 0) + 1
    return counts


def conditional_closed_form(L: int, r: int, N: int):
    """|sum_{k<N} e^{2 pi i k r x / 2^L}|^2 / 2^(2L) over x in [0, 2^L)."""
    import numpy as np

    Q = 1 << L
    m = (r * np.arange(Q, dtype=np.int64)) % Q
    theta = np.pi * m / Q
    s = np.sin(theta)
    g = np.where(m == 0, float(N * N), np.sin(N * theta) ** 2 / np.where(m == 0, 1.0, s * s))
    return g / float(Q) ** 2


def period_marginal(L: int, r: int):
    """The closed form of period finding,
    P(x) = 2^-2L sum_{s<r} |sum_{k<N_s} e^{2 pi i k r x / 2^L}|^2."""
    return sum(c * conditional_closed_form(L, r, N) for N, c in _counts(L, r).items())


def full_register_predictor(C: int, a: int, L: int, M: int, r: int):
    """draw -> (logical index, margin): the index the two-level sampler
    picks on the exact state of the m_high period-finding circuit, from
    the joint distribution in physical order (work register y = a^s mod C
    in the high bits, the bit-reversed frequency in the low bits), and the
    draw's distance to the nearest cumulative boundary."""
    import numpy as np

    Q = 1 << L
    rev = bitrev_table(L)
    cum = {N: np.cumsum(conditional_closed_form(L, r, N)[rev]) for N in _counts(L, r)}
    ys = [pow(a, s, C) for s in range(r)]
    order = sorted(range(r), key=lambda s: ys[s])
    totals = np.array([((Q - 1 - s) // r + 1) / Q for s in order])
    cum_blocks = np.cumsum(totals)

    def predict(draw: float):
        pos = draw * cum_blocks[-1]
        b = min(int(np.searchsorted(cum_blocks, pos, side="left")), r - 1)
        s = order[b]
        local = pos - (cum_blocks[b] - totals[b])
        cs = cum[(Q - 1 - s) // r + 1]
        i = min(int(np.searchsorted(cs, local, side="left")), Q - 1)
        margin = min(local - (cs[i - 1] if i else 0.0), cs[i] - local)
        phys = (ys[s] << L) | i
        return (phys >> L) | ((phys & (Q - 1)) << M), float(margin)

    return predict


def first_draws(seeds):
    """The draw the Shor driver's first attempt makes for each --seed:
    key = PRNGKey(seed); key, sub = split(key); r = uniform(sub, f32)."""
    import jax
    import jax.numpy as jnp

    def draw(seed):
        return jax.random.uniform(jax.random.split(jax.random.PRNGKey(seed))[1], dtype=jnp.float32)

    return [float(v) for v in jax.jit(jax.vmap(draw))(jnp.asarray(list(seeds), jnp.int32))]


def pick_seeds(C, a, L, M, r, factors, count, limit=400):
    """The `count` seeds, among the first `limit`, whose predicted first
    attempt factors C, widest draw margin first.  Where single entries of
    the distribution are smaller than the device's f32 cumulative error the
    device may pick a neighbouring index, so callers allow a few tries."""
    from quantumcomputer.algorithms import number_theory as nt
    from quantumcomputer.algorithms.shor import _validate_and_factor, read_omega

    predict = full_register_predictor(C, a, L, M, r)
    good = []
    for seed, draw in zip(range(limit), first_draws(range(limit))):
        idx, margin = predict(draw)
        period = nt.find_period_from_omega(read_omega(idx, L, M), a, C)
        if period is not None and _validate_and_factor(C, a, period)[2] == factors:
            good.append((margin, seed))
    return [seed for _, seed in sorted(good, reverse=True)[:count]]


def factor_through_cli(argv, seeds, out, tag):
    """Run the CLI with each seed until it factors: (tries, period, factors)."""
    got = (None, None, None, "")
    for tries, seed in enumerate(seeds, 1):
        t0 = time.perf_counter()
        got = run_cli(list(argv) + ["--seed", seed])
        out(f"  {tag}: CLI seed {seed}: rc {got[0]}, period {got[1]}, factors {got[2]}, "
            f"{time.perf_counter() - t0:.1f} s")
        if got[0] == 0 and got[2] is not None:
            return tries, got[1], got[2]
    return math.inf, got[1], got[2]


def run_cli(argv):
    """cli.main with stdout captured: (return code, period, factors, text)."""
    from quantumcomputer.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(v) for v in argv])
    text = buf.getvalue()
    p = re.search(r"valid period = (\d+)", text)
    f = re.search(r"Factors of \d+ found: \((\d+), (\d+)\)", text)
    return (
        rc,
        int(p.group(1)) if p else None,
        (int(f.group(1)), int(f.group(2))) if f else None,
        text,
    )


def multiplicative_order(a: int, C: int) -> int:
    return _predictor().multiplicative_order(a, C)


def _predictor():
    spec = importlib.util.spec_from_file_location(
        "predict_semiclassical", os.path.join(REPO, "scripts", "predict_semiclassical.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tv(p, q) -> float:
    import numpy as np

    return 0.5 * float(np.abs(np.asarray(p, np.float64) - np.asarray(q, np.float64)).sum())


# -- phase 1 and 4: gate classes and the sampler ------------------------------------------


def gate_classes(n: int):
    """(label, gate, m_reg) at low, mid and high strides; m_reg is the work
    register of the m_high oracle gates (None for the others)."""
    import numpy as np

    from quantumcomputer.models import circuit as cir
    from quantumcomputer.models.circuit import Gate

    rng = np.random.default_rng(7)
    u2 = np.linalg.qr(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))[0]
    u4 = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    lo, mid, hi = 0, n // 2, n - 1
    C, m_reg = 8191, 13
    rest = n - m_reg
    c_lo, c_mid, c_hi = 0, rest // 2, rest - 1
    out = []
    for q in (lo, mid, hi):
        out.append((f"1q q={q}", cir.U1Q(q, u2), None))
    for q in (lo, mid, hi):
        out.append((f"diag q={q}", cir.PHASE(q, 0.7), None))
    for q_hi, q_lo in ((5, 2), (mid + 3, mid - 4), (hi, hi - 3)):
        out.append((f"2q ({q_hi},{q_lo})", cir.U2Q(q_hi, q_lo, u4), None))
    for c in (c_lo, c_mid, c_hi):
        out.append((f"camodc_high c={c}", Gate("camodc_high", (c,), meta=(C, 3, m_reg)), m_reg))
    controls = (c_lo, c_mid, c_hi)
    As = tuple(pow(3, 1 << j, C) for j in range(3))
    out.append((f"ladder c={controls}", Gate("camodc_ladder_high", controls, meta=(C, m_reg) + As), m_reg))
    for l in (3, mid, hi):
        out.append((f"iqft_stage l={l}", cir.IQFT_STAGE(l), None))
    return out


def reference_apply(psi, g, n: int, m_reg):
    """complex128 reference of one gate (sim/reference.py); m_high oracles
    are mapped to the standard layout and back."""
    import numpy as np

    from quantumcomputer.models import circuit as cir
    from quantumcomputer.sim import reference as ref

    if g.name in ("camodc_high", "camodc_ladder_high"):
        L = n - m_reg
        idx = np.arange(1 << n)
        logical = (idx >> L) | ((idx & ((1 << L) - 1)) << m_reg)
        x = np.empty_like(psi)
        x[logical] = psi
        C = g.meta[0]
        pairs = [(g.meta[1], g.qubits[0])] if g.name == "camodc_high" else list(zip(g.meta[2:], g.qubits))
        for A, c in pairs:
            x = ref.apply_c_amodc(x, C, A, m_reg + c, m_reg)
        return x[logical]
    if g.name == "iqft_stage":
        l = g.qubits[0]
        out = ref.apply_hadamard(psi, l)
        for k in range(l - 1, -1, -1):
            out = ref.apply_c_phase(out, l, k, math.pi / (1 << (l - k)))
        return out
    if len(g.qubits) == 1:
        return ref.apply_1q(psi, cir.gate_matrix_1q(g), g.qubits[0])
    return ref.apply_2q(psi, cir.gate_matrix_2q(g), g.qubits[0], g.qubits[1])


def gate_class_checks(n: int, dtypes) -> list:
    import jax.numpy as jnp
    import numpy as np

    from quantumcomputer.sim.engine import Register, StateVectorEngine

    rng = np.random.default_rng(n)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    engines = {
        dt: StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128 if dt == "complex128"
                              else jnp.complex64 if dt == "complex64" else "complex32")
        for dt in dtypes
    }
    checks = []
    for label, g, m_reg in gate_classes(n):
        want = reference_apply(psi, g, n, m_reg)
        scale = float(np.abs(want).max())
        for dt, eng in engines.items():
            s0 = jnp.asarray(np.stack([psi.real, psi.imag]).astype(np.float64)).astype(eng.real_dtype)
            got = eng.to_numpy(eng.run((g,), s0))
            err = float(np.abs(got - want).max())
            if dt == "complex32":
                err /= scale
            checks.append(Check(f"{dt} {label}", err, TOL[dt]))
    return checks


def sampler_checks(n_parity: int, n_timing: int, out=print) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantumcomputer.ops import measure

    checks = []
    k = jax.random.PRNGKey(3)
    planes = jax.random.normal(k, (2, 1 << n_parity), jnp.float32)
    planes = planes / jnp.sqrt(jnp.sum(planes * planes))
    re, im = planes[0], planes[1]
    sums = np.asarray(jax.jit(measure.block_prob_sums_planes)(re, im), np.float64)
    p = np.asarray(re, np.float64) ** 2 + np.asarray(im, np.float64) ** 2
    nb, bl = measure.block_geom(1 << n_parity)
    want = p.reshape(nb, bl).sum(axis=1)
    checks.append(Check(f"block sums n={n_parity} (max rel vs f64)", np.max(np.abs(sums - want) / want), 1e-5))
    draws = np.array(jax.random.uniform(jax.random.PRNGKey(4), (257,), jnp.float32))
    draws[0], draws[-1] = 0.0, np.float32(0.99999994)
    got = np.asarray(jax.jit(measure.sample_indices_planes)(re, im, jnp.asarray(draws)))
    cum = np.cumsum(p)
    # A pick is right when the draw lies in its cumulative bracket; f32
    # partial sums may move a knife-edge draw by one index only.
    pos = draws.astype(np.float64) * cum[-1]
    lo = np.where(got > 0, cum[np.maximum(got - 1, 0)], 0.0)
    outside = np.maximum(lo - pos, 0.0) + np.maximum(pos - cum[got], 0.0)
    flat = np.minimum(np.searchsorted(cum, pos, side="left"), (1 << n_parity) - 1)
    out(f"  two-level vs flat f64 scan: {int((got == flat).sum())}/{len(draws)} identical indices")
    checks.append(Check(f"two-level draws n={n_parity} (max bracket miss)", outside.max(), 1e-6))

    dim = 1 << n_timing
    re_t = jax.jit(lambda: jnp.full((dim,), 2.0 ** (-n_timing / 2), jnp.float32))()
    im_t = jnp.zeros_like(re_t)
    t_sums = _timed(jax.jit(measure.block_prob_sums_planes), re_t, im_t)
    t_draw = _timed(jax.jit(measure.sample_index_planes), re_t, im_t, jnp.float32(0.37))
    out(f"  n={n_timing} block sums {t_sums * 1e3:.3f} ms ({2 * dim * 4 / t_sums / 1e9:.0f} GB/s), "
        f"one draw {t_draw * 1e3:.3f} ms")
    return checks


def phase_kernels(out=print) -> list:
    return sampler_checks(SAMPLER_PARITY_N, SAMPLER_TIMING_N, out) + gate_class_checks(
        GATE_N, ("complex64", "complex32")
    )


def phase_complex128(out=print) -> list:
    import jax

    with jax.enable_x64(True):
        return gate_class_checks(GATE_N, ("complex128",))


# -- phase 2: full-register factorizations ----------------------------------------------------


def full_register_checks(cases, out=print) -> list:
    import jax.numpy as jnp
    import numpy as np

    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    checks = []
    marginals: dict = {}
    for C, a, L, M, dtype, r, factors, tv_tol in cases:
        tag = f"C={C} L={L} M={M} {dtype}"
        checks.append(Check(f"{tag} order of a (|ord - {r}|)", abs(multiplicative_order(a, C) - r), 0))
        eng = StateVectorEngine(
            Register(L=L, M=M), dtype=jnp.complex64 if dtype == "complex64" else dtype, layout="m_high"
        )
        circ = shor_circuit_mhigh(C, a, L, M)
        t0 = time.perf_counter()
        marg = np.asarray(eng.run_marginal(circ, L), np.float64)
        t1 = time.perf_counter()
        np.asarray(eng.run_marginal(circ, L))
        out(f"  {tag}: circuit + marginal {time.perf_counter() - t1:.3f} s "
            f"({t1 - t0:.1f} s with compile, {len(circ)} gates)")
        if (C, a, L, M) in marginals:
            out(f"  {tag}: TV to the complex64 marginal {_tv(marg, marginals[(C, a, L, M)]):.3e}")
        marginals[(C, a, L, M)] = marg
        want = period_marginal(L, r)[bitrev_table(L)]
        checks.append(Check(f"{tag} L-marginal TV vs closed form", _tv(marg, want), tv_tol))
        tries_allowed = 3 if dtype == "complex64" else 5
        argv = ["-C", C, "-L", L, "-M", M, "-a", a, "--layout", "m_high", "--dtype", dtype, "-v"]
        tries, period, got = factor_through_cli(
            argv, pick_seeds(C, a, L, M, r, factors, tries_allowed), out, tag
        )
        checks.append(Check(f"{tag} CLI factors {factors} (tries)", tries if got == factors else math.inf,
                            tries_allowed))
        checks.append(Check(f"{tag} CLI period (|p - {r}|)", abs((period or 0) - r), 0))
    return checks


def phase_full_register(out=print) -> list:
    return full_register_checks(FULL_REGISTER_CASES, out)


# -- phase 3: semiclassical -------------------------------------------------------------------


def step_seconds(C, a, M, structured: bool) -> float:
    import jax
    import jax.numpy as jnp

    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    key = jax.random.PRNGKey(0)
    walls = {}
    for L in (1, 4):
        run_semiclassical(C, a, L, M, key, jnp.complex64, structured=structured)
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run_semiclassical(C, a, L, M, key, jnp.complex64, structured=structured)
            best = min(best, time.perf_counter() - t0)
        walls[L] = best
    return (walls[4] - walls[1]) / 3


def semiclassical_checks(case, out=print, steps: bool = True) -> list:
    import jax

    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    C, a, L, M, r, factors, seed = case
    checks = [Check(f"C={C} order of a (|ord - {r}|)", abs(multiplicative_order(a, C) - r), 0)]
    pred = _predictor().predict_attempt(C, a, L, seed, r)
    t0 = time.perf_counter()
    rc, period, got, _ = run_cli(["-C", C, "-L", L, "-M", M, "-a", a, "--semiclassical", "--seed", seed, "-v"])
    out(f"  CLI --semiclassical L={L} M={M}: rc {rc}, period {period}, factors {got}, "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    checks.append(Check(f"C={C} CLI factors {factors}", 0 if (rc == 0 and got == factors) else 1, 0))
    checks.append(Check(f"C={C} CLI period (|p - {r}|)", abs((period or 0) - r), 0))
    rec = run_semiclassical(C, a, L, M, jax.random.split(jax.random.PRNGKey(seed))[1])
    checks.append(Check("measured bits vs exact replay (mismatches)", sum(
        int(b != p) for b, p in zip(rec.bits, pred["bits"])), 0))
    if steps:
        for structured in (True, False):
            out(f"  M={M} step, structured={structured}: {step_seconds(C, a, M, structured) * 1e3:.3f} ms")
    return checks


def phase_semiclassical(out=print) -> list:
    return semiclassical_checks(SEMICLASSICAL_CASE, out)


# -- --chips 4: the sharded path ---------------------------------------------------------------


def sharded_marginal(state, mesh, low_bits: int):
    """Distribution of the `low_bits` lowest qubits of a sharded planar
    state: each card reduces its own shard (int32 local indices, no
    2^32-element global index math), then one psum."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from quantumcomputer.parallel.mesh import AXIS

    def body(s):
        p = s[0].astype(jnp.float32) ** 2 + s[1].astype(jnp.float32) ** 2
        return jax.lax.psum(jnp.sum(p.reshape(-1, 1 << low_bits), axis=0), AXIS)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(None, AXIS),), out_specs=P(), check_vma=False
    ))(state)


def sharded_checks(case, out=print) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    C, a, L, M, r, factors, devices = case
    n = L + M
    checks = []
    tries, period, got = factor_through_cli(
        ["-C", C, "-L", L, "-M", M, "-a", a, "--layout", "m_high", "--devices", devices, "-v"],
        pick_seeds(C, a, L, M, r, factors, 3), out, f"n={n} --devices {devices}",
    )
    checks.append(Check(f"n={n} sharded CLI factors {factors} (tries)", tries if got == factors else math.inf, 3))

    mesh = build_mesh(num_devices=devices)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh, layout="m_high")
    state = eng.run(shor_circuit_mhigh(C, a, L, M))
    shards = sorted((s.device.id, s.data.nbytes) for s in state.addressable_shards)
    out(f"  n={n} shard bytes per card: {shards} of {state.nbytes}")
    checks.append(Check(f"n={n} shards: |bytes - total/{devices}| max",
                        max(abs(b - state.nbytes // devices) for _, b in shards) + (len(shards) != devices), 0))
    want = period_marginal(L, r)[bitrev_table(L)]
    checks.append(Check(f"n={n} sharded L-marginal TV vs closed form",
                        _tv(np.asarray(sharded_marginal(state, mesh, L), np.float64), want), 1e-4))
    del state

    L1 = L - 1
    circ = shor_circuit_mhigh(C, a, L1, M)
    r1 = r
    want1 = period_marginal(L1, r1)[bitrev_table(L1)]
    single = StateVectorEngine(Register(L=L1, M=M), dtype=jnp.complex64, layout="m_high")
    m_single = np.asarray(single.run_marginal(circ, L1), np.float64)
    eng1 = ShardedStateVectorEngine(Register(L=L1, M=M), dtype=jnp.complex64, mesh=mesh, layout="m_high")
    m_shard = np.asarray(sharded_marginal(eng1.run(circ), mesh, L1), np.float64)
    checks.append(Check(f"n={n - 1} sharded vs one-card marginal TV", _tv(m_shard, m_single), 1e-4))
    checks.append(Check(f"n={n - 1} one-card L-marginal TV vs closed form", _tv(m_single, want1), 1e-4))
    checks.append(Check(f"n={n - 1} sharded L-marginal TV vs closed form", _tv(m_shard, want1), 1e-4))
    return checks


def phase_sharded(out=print) -> list:
    return sharded_checks(SHARDED_CASE, out)


PHASES = {
    "kernels": phase_kernels,
    "full_register": phase_full_register,
    "semiclassical": phase_semiclassical,
    "complex128": phase_complex128,
    "sharded": phase_sharded,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.chips:
        print(f"need {args.chips} GPU(s); JAX found {devices}", file=sys.stderr)
        return 2
    devices = devices[: args.chips]
    from quantumcomputer.utils.compile_cache import enable
    from quantumcomputer.utils.memory import device_hbm_budget

    cache = enable()
    smi = smi_line()
    print(f"gpu: {smi}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}")
    print(f"device: {devices[0].device_kind} x{len(devices)}; "
          f"bytes_limit {(devices[0].memory_stats() or {}).get('bytes_limit')}; "
          f"planner budget device_hbm_budget() = {device_hbm_budget()}", flush=True)
    ok = run_phases([(name, PHASES[name]) for name in select_phases(args.chips)],
                    out=lambda s: print(s, flush=True))
    if not ok:
        return 1
    print(smi)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
