"""Structured modular-stride permutation: out[j] = x[(m*j) mod C] by
transposes and wide slices instead of a per-element gather.

The semiclassical oracle (algorithms/semiclassical.py) applies the work
register permutation j -> (a_inv * j) mod C (j < C; identity above — the
reference's index walk, qc_shor.c:595-660) as an element gather by
default.  This module is the alternative (structured=True): the same
permutation without a per-element index (the two are timed against each
other in PERF.md).

This module applies the SAME permutation with structured data movement
only — reshapes, transposes, and wide contiguous slices:

  1. Rational reconstruction (continued fractions of a_inv/C) writes
     a_inv = eps * u * v^{-1} (mod C) with u, v ~ sqrt(C).  Multiplier
     permutations F_m(x)[j] = x[(m*j) mod C] compose multiplicatively
     (F_m1 . F_m2 = F_m1*m2, all commuting), so
         F_a_inv = F_eps . F_u . F_{v^{-1}}.
  2. F_u for SMALL u ("deal" leg): the source index (u*j) mod C, split as
     q*u + t, walks columns of the (ceil(C/u), u) row-major view of x.
     Transposing that view makes every output chunk of W lanes TWO
     contiguous row slices (the mod-C wrap crosses a W-chunk at most once
     when W*u <= C) blended by a lane predicate.
  3. F_{v^{-1}} for SMALL v ("collect" leg): with the output index split
     as q*v + t, out[q*v + t] = x[(j0(t) + q) mod C] where
     j0(t) = (v^{-1} t) mod C — whole contiguous rows from a cyclically
     extended copy of x, then one transpose back to flat order.
  4. F_{-1} is an index reversal (contiguous flip).

Every array op is dtype-agnostic data movement; all index arithmetic runs
in int32 via the shift-add modular multiply (ops/gates.modmul_onchip), so
the path is exact for any C < 2^30 without x64.

C, a_inv, M are STATIC here (compiled per step value); the semiclassical
driver caches programs per (C, a_inv, M, dtype).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from quantumcomputer.ops.gates import modmul_onchip

# Output-chunk width for the deal leg: wider chunks = fewer, bigger slices,
# but the no-second-wrap invariant needs W*u <= C, so W adapts downward
# for large u.  The y0 padding the slices need is 2*W*u elements, <= 2
# extra streamed state passes at the cap.
_MAX_CHUNK = 16384
_MIN_CHUNK = 128


def _tile_friendly(f: int, min_factor: int = 32) -> bool:
    """Acceptance floor for rational_split: non-unit factors below
    min_factor make slices too narrow to beat the element gather."""
    return f == 1 or f >= min_factor


def rational_split(
    a_inv: int, C: int, min_factor: int = 32
) -> Optional[Tuple[int, int, int]]:
    """Write a_inv = eps * u * v^{-1} (mod C) with u, v as balanced as the
    continued-fraction lattice allows (both ~sqrt(C) generically).

    Returns (eps, u, v) with u, v > 0, eps in {+1, -1}, or None when every
    balanced convergent shares a factor with C (then gcd(u, C) > 1 would
    make v non-invertible — in Shor's setting that shared factor would
    itself be an answer, but this layer stays a pure permutation op and
    lets the caller fall back).

    Extended Euclid on (C, a_inv) maintains r_i = s_i*C + t_i*a_inv, i.e.
    a_inv * t_i = r_i (mod C): u = r_i, v = |t_i|, eps = sign(t_i).
    |r_i| shrinks as |t_i| grows, so the best split minimizes
    max(r_i, |t_i|) over the remainder sequence.
    """
    a_inv %= C
    if a_inv == 0 or math.gcd(a_inv, C) != 1:
        return None
    r0, r1 = C, a_inv
    t0, t1 = 0, 1
    best = None
    best_cost = None
    while r1 > 0:
        cost = max(r1, abs(t1))
        if (
            math.gcd(r1, C) == 1
            and _tile_friendly(r1, min_factor)
            and _tile_friendly(abs(t1), min_factor)
            and (best_cost is None or cost < best_cost)
        ):
            best, best_cost = (1 if t1 > 0 else -1, r1, abs(t1)), cost
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
    return best


@dataclass(frozen=True)
class StridePlan:
    """Static plan for one structured permutation (per (C, a_inv, M))."""

    C: int
    M: int
    eps: int
    u: int       # deal-leg multiplier (1 = skip)
    v: int       # collect-leg structure parameter (1 = skip)
    vinv: int    # v^{-1} mod C (the collect leg's row-start multiplier)
    W: int       # deal-leg output chunk width


def plan_stride_permute(
    C: int, a_inv: int, M: int, max_chunk: int = _MAX_CHUNK,
    min_factor: int = 32,
) -> Optional[StridePlan]:
    """Build the static plan, or None when the structured path does not
    apply: the permutation must be nontrivial, the deal chunking needs
    W*u <= C with a slice-worthy W, and the collect rows (width ~C/v) must
    be wide enough to beat element gathers.

    max_chunk caps the deal-leg chunk width W: the leg's transient padding
    is 2*W*u elements, so memory-ceiling callers (the semiclassical driver
    at the largest M) pass a lower cap to trade slice width for peak
    footprint.

    min_factor: acceptance floor for non-unit split factors."""
    dim = 1 << M
    if C > dim or C >= (1 << 30):
        return None
    a_inv %= C
    if a_inv <= 1:
        return None
    split = rational_split(a_inv, C, min_factor)
    if split is None:
        return None
    eps, u, v = split
    # Chunk width for the deal leg: largest power of two with W*u <= C.
    W = max_chunk
    while W > dim:
        W //= 2
    while W >= _MIN_CHUNK and W * u > C:
        W //= 2
    if u > 1 and W < _MIN_CHUNK:
        return None
    # Collect rows are ceil(C/v) wide; below 128 elements the slices
    # degenerate toward the element-gather regime this path replaces.
    if v > 1 and (C - 1) // v + 1 < _MIN_CHUNK:
        return None
    vinv = pow(v, -1, C) if v > 1 else 1
    return StridePlan(C=C, M=M, eps=eps, u=u, v=v, vinv=vinv, W=W)


def _negate_mod(x: jax.Array, C: int) -> jax.Array:
    """F_{-1}: out[0] = x[0], out[j] = x[C - j] for 0 < j < C, identity
    above."""
    dim = x.shape[-1]
    head = x[..., :1]
    body = jnp.flip(x[..., 1:C], axis=-1)
    if C == dim:
        return jnp.concatenate([head, body], axis=-1)
    return jnp.concatenate([head, body, x[..., C:]], axis=-1)


LANE = 128


def _deal_leg(x: jax.Array, C: int, u: int, M: int, W: int) -> jax.Array:
    """F_u for small u: out[j] = x[(u*j) mod C] (j < C), x[j] above.

    Source flat index rem(j) = (u*j) mod C, split rem = q*u + t
    (t in [0, u)).  In the transposed (u, Qp) view y0[t, q] = x[q*u + t],
    one W-lane output chunk starting at j0 is:

        lanes i <  i*: y0[t1, q1 + i]      (t1 = rem0 % u, q1 = rem0 // u)
        lanes i >= i*: y0[t2, i - i*]      (the single mod-C wrap)

    with rem0 = (u*j0) mod C, i* = ceil((C - rem0)/u) clamped to [0, W],
    t2 = rem0 + i**u - C.  W*u <= C guarantees at most one wrap per chunk.
    Both sides are W-wide contiguous row slices; a lane select blends.
    """
    dim = 1 << M
    lead = x.shape[:-1]
    xf = x.reshape((-1, dim))
    B = xf.shape[0]
    Qp = (C - 1) // u + 1
    used = min(dim, Qp * u)

    # Only chunks touching the live region j < C are computed: the
    # identity tail is appended as a STATIC concat (C is static).
    NC = -(-C // W)
    j0 = lax.iota(jnp.int32, NC) * W
    nbits = max(1, u.bit_length())
    rem0 = modmul_onchip(u, j0, C, nbits)
    t1 = rem0 % u
    q1 = rem0 // u
    istar = jnp.clip((C - rem0 + u - 1) // u, 0, W)
    t2 = jnp.clip(rem0 + istar * u - C, 0, u - 1)
    zero = jnp.zeros((), jnp.int32)
    lane = lax.iota(jnp.int32, W)

    # [W*u zeros | x viewed (Qp, u), zero-padded past dim | W*u zeros] as
    # ONE flat concatenation, then the (W + Qp + W, u) view transposed.
    # The W-row pads become column pads of y0: W on the left (the wrapped
    # slice starts at W - i* >= 0) and W on the right (the straight slice
    # ends at q1 + W <= Qp + W - 1).
    mid = xf[:, :used]
    if Qp * u > used:
        mid = jnp.pad(mid, ((0, 0), (0, Qp * u - used)))
    zpad = jnp.zeros((B, W * u), xf.dtype)
    flatpad = jnp.concatenate([zpad, mid, zpad], axis=1)
    R = W + Qp + W
    y0 = jnp.swapaxes(flatpad.reshape(B, R, u), 1, 2)  # (B, u, W + Qp + W)

    pitch = y0.shape[2]
    if y0.shape[1] * pitch < (1 << 31):
        # Flat 1D slice starts (int32 flat indexing bounds the option).
        y0f = y0.reshape(B, y0.shape[1] * pitch)
        s0 = t1 * pitch + (W + q1)
        s1 = t2 * pitch + (W - istar)

        # Blend INSIDE the vmapped chunk: the two W-slices fuse into
        # the select without materializing dim-sized g0/g1.
        def chunk1(a, b, isc):
            g0 = lax.dynamic_slice(y0f, (zero, a), (B, W))
            g1 = lax.dynamic_slice(y0f, (zero, b), (B, W))
            return jnp.where(lane[None, :] < isc, g0, g1)

        out = jax.vmap(chunk1, in_axes=(0, 0, 0), out_axes=1)(s0, s1, istar)
    else:

        def chunk(t1c, q1c, isc, t2c):
            g0 = lax.dynamic_slice(y0, (zero, t1c, W + q1c), (B, 1, W))
            g1 = lax.dynamic_slice(y0, (zero, t2c, W - isc), (B, 1, W))
            return jnp.where(lane[None, None, :] < isc, g0, g1)

        out = jax.vmap(chunk, in_axes=(0, 0, 0, 0), out_axes=2)(t1, q1, istar, t2)
    flat = out.reshape(B, NC * W)
    if C < dim:
        flat = jnp.concatenate([flat[:, :C], xf[:, C:]], axis=-1)
    return flat.reshape(lead + (dim,))


def _collect_leg(x: jax.Array, C: int, v: int, vinv: int, M: int) -> jax.Array:
    """F_{v^{-1}} for small v: out[j] = x[(v^{-1}*j) mod C] (j < C).

    Split the OUTPUT index j = q*v + t: out[q*v + t] =
    x[(v^{-1}*t + q) mod C] — for each t, a contiguous (mod C) run of
    length ~C/v starting at j0(t) = (v^{-1}*t) mod C.  A cyclic extension
    x_ext = [x[:C], x[:Qpr]] absorbs the single wrap, so every row is one
    wide slice; transposing (v, Qpv) -> (Qpv, v) restores flat order.
    """
    dim = 1 << M
    lead = x.shape[:-1]
    xf = x.reshape((-1, dim))
    B = xf.shape[0]
    Qpv = (C - 1) // v + 1
    # Rows are gathered at a lane-aligned width Qpr >= Qpv: the cyclic
    # extension provides valid (discarded) continuation data, dropped by
    # the post-transpose compaction slice.
    Qpr = -(-Qpv // LANE) * LANE

    t = lax.iota(jnp.int32, v)
    nbits = max(1, C.bit_length())
    j0 = modmul_onchip(vinv, t, C, nbits)
    zero = jnp.zeros((), jnp.int32)

    x_ext = jnp.concatenate([xf[:, :C], xf[:, : min(Qpr, dim)]], axis=-1)
    if Qpr > dim:
        x_ext = jnp.pad(x_ext, ((0, 0), (0, Qpr - dim)))

    def row(j0c):
        return lax.dynamic_slice(x_ext, (zero, j0c), (B, Qpr))

    w2 = jnp.swapaxes(jax.vmap(row, out_axes=1)(j0), 1, 2)  # (B, Qpr, v)
    flat = w2[:, :Qpv, :].reshape(B, Qpv * v)[:, :C]
    if C < dim:
        flat = jnp.concatenate([flat, xf[:, C:]], axis=-1)
    return flat.reshape(lead + (dim,))


def apply_stride_permute(x: jax.Array, plan: StridePlan) -> jax.Array:
    """out[..., j] = x[..., (a_inv*j) mod C] for j < C, x[..., j] above —
    the modmul_inverse_permutation gather (ops/gates.py:271-288) as
    structured movement.  Traceable; all plan fields are static."""
    out = x
    if plan.v > 1:
        out = _collect_leg(out, plan.C, plan.v, plan.vinv, plan.M)
    if plan.u > 1:
        out = _deal_leg(out, plan.C, plan.u, plan.M, plan.W)
    if plan.eps < 0:
        out = _negate_mod(out, plan.C)
    return out


def modmul_stride_permute(x: jax.Array, C: int, a_inv: int, M: int) -> jax.Array:
    """Convenience one-shot form (plan + apply); returns x permuted, or
    raises if the structured path does not apply (callers that need a
    fallback should use plan_stride_permute directly)."""
    plan = plan_stride_permute(C, a_inv, M)
    if plan is None:
        raise ValueError(
            f"structured stride permutation unsupported for C={C}, "
            f"a_inv={a_inv}, M={M}"
        )
    return apply_stride_permute(x, plan)
