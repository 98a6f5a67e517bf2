"""dd64 semiclassical period finding: f64-grade parity for the
one-control-qubit engine, from f32 arithmetic.

Completes the dtype matrix: the full-register engine has a double-float
parity mode (sim/dd_engine.py — two-f32 error-free transforms, <=1e-12
vs the f64 oracle, replacing the reference's GSL
complex-doubles, qc_shor.c:105-112), and this module gives the
semiclassical engine (algorithms/semiclassical.py) the same grade.  A
semiclassical attempt is L SEQUENTIAL measure-collapse-renormalize
steps, so storage roundoff compounds where the full-register circuit
pays it once — exactly the place a parity mode earns its keep.

The implicit-control closed form is identical to the f32 engine's
(semiclassical.py module docstring):

    a1  = e^{i theta} U w          (U = modular-multiply permutation)
    b_m = (w + (-1)^m a1) / 2,   p_m = ||b_m||^2
    w' = (w + (-1)^m a1) / (2 sqrt(p_m))

realized in dd arithmetic with three design moves:

  - The state is a (4, 2^M) f32 planar array [re_hi, re_lo, im_hi,
    im_lo] (dd_engine's convention) — pure f32 on the device.
  - Division and square root NEVER run on device: the step is
    host-synchronous anyway (this is a parity mode, not the throughput
    path), so the renormalization scalar 1/(2 sqrt(p_m)) is computed on
    the host in f64 from the fetched dd branch weight and shipped back
    as a split (hi, lo) pair; the device only ever multiplies.  The
    same goes for the deferred-phase rotation: theta = pi*phi with phi
    maintained exactly on the host (phi has <= L <= 52 bits), and
    cos/sin evaluated in f64 and split — dd-grade trig without dd trig.
  - One step = THREE small device programs (rotate-gather, branch
    weights, collapse) rather than one fused one: XLA:CPU recomputes
    shared values into multiple fusion clusters with inconsistent
    rounding once a program grows, corrupting the error-free transforms
    (measured in dd_engine — its CPU mode dispatches per gate for the
    same reason).  Keeping each EFT chain inside one small program keeps
    the CPU test suite meaningful for every device.

Halving by 2 and the (-1)^m sign are exact on (hi, lo) pairs (powers of
two scale both halves exactly), so the only inexact device steps are the
dd rotation, the dd accumulation, and the final dd scale — ~1e-15
relative each, matching the complex128 oracle to <=1e-12 over full
attempts (tests/test_semiclassical_dd.py).
"""

from __future__ import annotations

import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from quantumcomputer.ops import dd
from quantumcomputer.ops import gates as xops
from quantumcomputer.utils.logging import get_logger

log = get_logger("semiclassical")


def _unpack(w4):
    return (w4[0], w4[1]), (w4[2], w4[3])


def _pack(re, im):
    return jnp.stack([re[0], re[1], im[0], im[1]])


def _rotate_gather_fn(M: int):
    """a1 = e^{i theta} U w: on-device index generation (two int32
    scalars — no 2^M host table, semiclassical.py docstring), permutation
    gather of all four dd planes (exact), then one dd complex rotation by
    the host-split (cos, sin) scalars."""

    def f(w4, C_s, a_inv_s, ct_hi, ct_lo, st_hi, st_lo):
        idx = xops.modmul_permute_onchip(a_inv_s, lax.iota(jnp.int32, 1 << M), C_s, M)
        g4 = w4[:, idx]
        gre, gim = _unpack(g4)
        ct = (ct_hi, ct_lo)
        st = (st_hi, st_lo)
        a1re, a1im = dd.cmul(gre, gim, ct, st)
        return _pack(a1re, a1im)

    return jax.jit(f)


def _branch_probs_fn():
    """p_m = ||(w + (-1)^m a1) / 2||^2 for both branches, in dd.  The
    halving scales hi and lo exactly; products are two_prod-exact; the
    accumulation is a binary-tree dd fold (dd.tree_sum)."""

    def f(w4, a14):
        wre, wim = _unpack(w4)
        are, aim = _unpack(a14)

        def p_of(sign):
            bre = dd.add(wre, (sign * are[0], sign * are[1]))
            bim = dd.add(wim, (sign * aim[0], sign * aim[1]))
            bre = (bre[0] * 0.5, bre[1] * 0.5)
            bim = (bim[0] * 0.5, bim[1] * 0.5)
            s = dd.add(dd.mul(bre, bre), dd.mul(bim, bim))
            return dd.tree_sum(s)

        p0 = p_of(np.float32(1.0))
        p1 = p_of(np.float32(-1.0))
        return p0[0], p0[1], p1[0], p1[1]

    return jax.jit(f)


def _collapse_fn():
    """w' = (w + sign * a1) * scale with scale = 1/(2 sqrt(p_m)) split on
    the host — the one dd multiply whose operand is not a power of two."""

    def f(w4, a14, sign, sc_hi, sc_lo):
        wre, wim = _unpack(w4)
        are, aim = _unpack(a14)
        sc = (sc_hi, sc_lo)
        tre = dd.add(wre, (sign * are[0], sign * are[1]))
        tim = dd.add(wim, (sign * aim[0], sign * aim[1]))
        return _pack(dd.mul(tre, sc), dd.mul(tim, sc))

    return jax.jit(f, donate_argnums=(0,))


def run_semiclassical_dd(
    C: int,
    a: int,
    L: int,
    M: int,
    key: jax.Array,
    forced_bits: Optional[List[int]] = None,
    _cache: dict = {},
):
    """One dd64 semiclassical attempt: the parity-grade sibling of
    semiclassical.run_semiclassical (same record contract; argument
    validation happens there — this driver is reached through it).

    Host-synchronous per step by design (docstring): the branch weights
    are fetched to decide the bit and build the renormalization scalar,
    so each step costs two host round-trips.  Parity runs use moderate M;
    the throughput path is the f32/bf16 engine.
    """
    from quantumcomputer.algorithms.semiclassical import SemiclassicalRecord

    rot = _cache.get(("rot", M))
    if rot is None:
        rot = _cache[("rot", M)] = _rotate_gather_fn(M)
    probs_fn = _cache.get("probs")
    if probs_fn is None:
        probs_fn = _cache["probs"] = _branch_probs_fn()
    collapse = _cache.get("collapse")
    if collapse is None:
        collapse = _cache["collapse"] = _collapse_fn()

    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    # f32 draws (the dd state carries ~49-bit amplitudes, but a draw only
    # needs to split p0 vs p1; the c128 oracle draws in f64, so unforced
    # runs are distribution-equal, not draw-identical).
    rs = np.asarray(jax.random.uniform(key, (L,), jnp.float32), np.float64)
    C_s = jnp.asarray(C, jnp.int32)

    dim = 1 << M
    w4 = np.zeros((4, dim), np.float32)
    w4[0, 1] = 1.0  # |1>, control implicit (reset_register, qc_shor.c:318-324)
    w4 = jnp.asarray(w4)

    bits: List[int] = []
    probs: List[float] = []
    phi = 0.0  # exact in f64: phi accumulates <= L <= 52 bits
    for s in range(L):
        theta = math.pi * phi
        ct_hi, ct_lo = dd.split_f64(np.float64(math.cos(theta)))
        st_hi, st_lo = dd.split_f64(np.float64(math.sin(theta)))
        a14 = rot(
            w4, C_s, jnp.asarray(a_invs[s], jnp.int32),
            jnp.asarray(ct_hi), jnp.asarray(ct_lo),
            jnp.asarray(st_hi), jnp.asarray(st_lo),
        )
        p0h, p0l, p1h, p1l = probs_fn(w4, a14)
        p0 = float(dd.to_f64((np.asarray(p0h), np.asarray(p0l))))
        p1 = float(dd.to_f64((np.asarray(p1h), np.asarray(p1l))))
        total = p0 + p1  # 1 up to roundoff
        bit = int(rs[s] * total >= p0)
        if forced_bits is not None:
            bit = int(forced_bits[s])
        p_branch = p1 if bit else p0
        # A forced dead branch has p_branch == 0 exactly; the f32 engine
        # leaves a meaningless collapsed state there by design — mirror
        # that with a zeroed state instead of dividing by zero.
        scale = 1.0 / (2.0 * math.sqrt(p_branch)) if p_branch > 0.0 else 0.0
        sc_hi, sc_lo = dd.split_f64(np.float64(scale))
        w4 = collapse(
            w4, a14, jnp.asarray(1.0 - 2.0 * bit, jnp.float32),
            jnp.asarray(sc_hi), jnp.asarray(sc_lo),
        )
        bits.append(bit)
        # total == 0 only past a dead forced branch (zeroed state): the
        # conditional is meaningless there — record NaN like the f32 path.
        probs.append(p_branch / total if total > 0.0 else math.nan)
        phi = (phi + bit) / 2.0

    return SemiclassicalRecord.from_bits(bits, probs)
