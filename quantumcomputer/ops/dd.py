"""Double-float ("dd32x2") arithmetic: ~49-bit-mantissa reals from f32 pairs.

The reference's double-precision parity envelope (Report §III.F; GSL
complex-double throughout, qc_shor.c:105-112) needs float64, which some
devices lack or run slowly.  This module provides the classic double-double construction
specialized to float32: every real x is carried as an unevaluated sum
x = hi + lo with |lo| <= ulp(hi)/2, giving ~2*24 = 48+ mantissa bits —
unit roundoff ~2^-49 = 1.8e-15, comfortably inside the 1e-12 full-circuit
parity target for the register sizes the reference demonstrates (n <= 13).

The kernels are error-free transforms (Dekker 1971, Knuth TAOCP v2):

  * two_sum(a, b)   -> (s, e) with s = fl(a+b), a+b = s+e EXACTLY;
  * split(a)        -> (a_hi, a_lo), 12-bit halves whose f32 products are
                       exact (Dekker splitting with 2^12+1);
  * two_prod(a, b)  -> (p, e) with p = fl(a*b), a*b = p+e EXACTLY.

All functions are elementwise over jnp arrays and shape-polymorphic; they
use only IEEE f32 add/mul (no matrix units) and run on any backend.
XLA does not reassociate floating-point ops, so the transforms'
ordering survives jit.

Representation: a DD value is a plain (hi, lo) tuple of same-shape f32
arrays.  Complex DD values are ((re_hi, re_lo), (im_hi, im_lo)).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

DD = Tuple[jnp.ndarray, jnp.ndarray]

_SPLITTER = 4097.0  # 2^12 + 1 (f32 has a 24-bit significand -> 12-bit halves)


def _fence(x):
    """Make a value opaque to XLA's optimizer.  Error-free transforms
    compute expressions like (a + b) - a whose VALUE is the rounding error;
    an algebraically-simplifying compiler folds them to b and silently
    destroys the low half.  That is exactly what happens when a whole
    circuit compiles as one program (intermediate values are visible to the
    simplifier; per-gate dispatch hides them behind program boundaries).
    lax.optimization_barrier is a compile-time fence with no runtime cost."""
    return lax.optimization_barrier(x)


# -- error-free transforms ---------------------------------------------------


def two_sum(a, b) -> DD:
    """s = fl(a+b) and the exact rounding error e: a + b == s + e."""
    s = _fence(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b) -> DD:
    """two_sum specialization valid when |a| >= |b| (or a == 0)."""
    s = _fence(a + b)
    e = b - (s - a)
    return s, e


def split(a) -> DD:
    """Dekker split of an f32 into 12-high/12-low-bit halves (products of
    halves are then exact in f32)."""
    t = _SPLITTER * a
    hi = t - _fence(t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> DD:
    """p = fl(a*b) and the exact error e: a * b == p + e."""
    p = _fence(a * b)
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


# -- dd arithmetic ------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    """dd + dd (Knuth/QD 'ddadd', ~1 ulp of the 49-bit format)."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def mul(x: DD, y: DD) -> DD:
    """dd * dd."""
    p1, p2 = two_prod(x[0], y[0])
    p2 = p2 + x[0] * y[1] + x[1] * y[0]
    return quick_two_sum(p1, p2)


def from_f32(a) -> DD:
    return a, jnp.zeros_like(a)


def zeros(shape) -> DD:
    z = jnp.zeros(shape, jnp.float32)
    return z, jnp.zeros_like(z)


def const(value: float, shape=()) -> DD:
    """Split a host-side float64 scalar into a dd constant: hi = f32(v),
    lo = f32(v - hi).  The tail can carry up to 29 significant bits, so
    rounding it to f32 leaves a relative error up to ~2^-48 — at the dd
    format's own precision, not exact (pi, e, sqrt2 all land here)."""
    hi = np.float32(value)
    lo = np.float32(np.float64(value) - np.float64(hi))
    if shape == ():
        return jnp.float32(hi), jnp.float32(lo)
    return jnp.full(shape, hi, jnp.float32), jnp.full(shape, lo, jnp.float32)


def split_f64(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: split a float64 array into (hi, lo) f32 planes."""
    a = np.asarray(arr, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(x: DD) -> np.ndarray:
    """Host-side: recombine into float64 (exact: both halves fit)."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


# -- complex dd ---------------------------------------------------------------
# A complex dd value is a (re: DD, im: DD) pair.


def cmul(xr: DD, xi: DD, yr: DD, yi: DD) -> Tuple[DD, DD]:
    """(xr + i xi) * (yr + i yi) in dd."""
    rr = sub(mul(xr, yr), mul(xi, yi))
    ri = add(mul(xr, yi), mul(xi, yr))
    return rr, ri


def caxpy(ar: DD, ai: DD, xr: DD, xi: DD, accr: DD, acci: DD) -> Tuple[DD, DD]:
    """acc += a * x (complex dd fused into adds of exact products)."""
    pr, pi = cmul(ar, ai, xr, xi)
    return add(accr, pr), add(acci, pi)


def tree_sum(x: DD) -> DD:
    """Exact-ish dd sum of a (dim,)-shaped dd vector by binary folding:
    log2(dim) vectorized dd adds, no reassociation surprises."""
    hi, lo = x
    n = hi.shape[-1]
    if n == 0:  # empty shard: sum is dd zero, not an IndexError
        return jnp.zeros(hi.shape[:-1], hi.dtype), jnp.zeros(lo.shape[:-1], lo.dtype)
    while n > 1:
        if n % 2:  # pad odd lengths with zero
            hi = jnp.concatenate([hi, jnp.zeros_like(hi[..., :1])], -1)
            lo = jnp.concatenate([lo, jnp.zeros_like(lo[..., :1])], -1)
            n += 1
        half = n // 2
        hi, lo = add((hi[..., :half], lo[..., :half]), (hi[..., half:], lo[..., half:]))
        n = half
    return hi[..., 0], lo[..., 0]
