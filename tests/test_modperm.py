"""Parity tests for the structured modular-stride permutation
(ops/modperm.py) against the table-gather oracle
(ops/gates.modmul_inverse_permutation)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.ops.gates import modmul_inverse_permutation
from quantumcomputer.ops.modperm import (
    apply_stride_permute,
    plan_stride_permute,
    rational_split,
)


def _ref_permute(x: np.ndarray, C: int, a_inv: int, M: int) -> np.ndarray:
    ginv = np.asarray(modmul_inverse_permutation(C, pow(a_inv, -1, C), M))
    return x[..., ginv]


def _check(C: int, a_inv: int, M: int, *, require_plan: bool) -> bool:
    plan = plan_stride_permute(C, a_inv, M)
    if plan is None:
        assert not require_plan, f"no plan for C={C} a_inv={a_inv} M={M}"
        return False
    rng = np.random.default_rng(C * 7919 + a_inv)
    x = rng.standard_normal((2, 1 << M)).astype(np.float32)
    got = np.asarray(apply_stride_permute(jnp.asarray(x), plan))
    want = _ref_permute(x, C, a_inv, M)
    np.testing.assert_array_equal(got, want)
    return True


def test_rational_split_reconstructs():
    rng = np.random.default_rng(0)
    for _ in range(200):
        C = int(rng.integers(5, 1 << 24)) | 1
        a_inv = int(rng.integers(2, C))
        if math.gcd(a_inv, C) != 1:
            continue
        split = rational_split(a_inv, C)
        if split is None:
            continue
        eps, u, v = split
        assert u > 0 and v > 0 and eps in (-1, 1)
        assert math.gcd(v, C) == 1
        assert (eps * u * pow(v, -1, C) - a_inv) % C == 0
        # Lattice bound: consecutive Euclid rows satisfy r*|t| < C, so
        # the chosen pair's product stays below C regardless of which
        # candidates the tile-friendliness floor removed.
        assert u * v < C
        # The floor itself: no factor in the catastrophic-tiling zone.
        assert u == 1 or u >= 32
        assert v == 1 or v >= 32


def test_split_balanced_at_scale():
    """For prime C no convergent is gcd-skipped, so the lattice bound
    max(u, v) <= sqrt(C)-scale is guaranteed."""
    rng = np.random.default_rng(1)
    C = 2147483647  # 2^31 - 1, prime
    for _ in range(50):
        a_inv = int(rng.integers(2, C))
        if math.gcd(a_inv, C) != 1:
            continue
        split = rational_split(a_inv, C)
        assert split is not None
        _, u, v = split
        assert max(u, v) <= 2 * math.isqrt(C) + 2


@pytest.mark.parametrize("M", [8, 10, 12, 14])
def test_fuzz_parity_small(M):
    rng = np.random.default_rng(M)
    planned = 0
    for _ in range(40):
        C = int(rng.integers(3, (1 << M) + 1)) | 1
        if C > (1 << M):
            C -= 2
        a = int(rng.integers(2, C)) if C > 3 else 2
        if math.gcd(a, C) != 1:
            continue
        a_inv = pow(a, -1, C)
        if a_inv <= 1:
            continue
        planned += _check(C, a_inv, M, require_plan=False)
    # At small M most moduli fall below the slice-width floor; the ones
    # that plan must be exact (asserted inside _check).


def test_fuzz_parity_large():
    """The regime the path exists for: C within a few percent of 2^M.
    A minority of multipliers legitimately refuse (their only balanced
    splits have a factor in the catastrophic-tiling zone, e.g.
    a_inv = 2^{-1} mod C); coverage must stay high, parity exact."""
    rng = np.random.default_rng(42)
    M = 18
    eligible = planned = 0
    for _ in range(25):
        C = int(rng.integers((1 << M) - (1 << 14), (1 << M) + 1)) | 1
        if C > (1 << M):
            C -= 2
        a = int(rng.integers(2, C))
        if math.gcd(a, C) != 1:
            continue
        a_inv = pow(a, -1, C)
        if a_inv <= 1:
            continue
        eligible += 1
        planned += _check(C, a_inv, M, require_plan=False)
    assert planned >= (3 * eligible) // 4, (planned, eligible)


def test_power_of_two_dim_modulus():
    # C == 2^M is even, never coprime with a — but C = 2^M - 1 is the
    # densest legal case (no identity tail beyond one element).  It is
    # also highly composite (3*5*17*257): many convergents gcd-skip, so
    # some multipliers (a=7) land with no tile-friendly split and must
    # refuse cleanly; others plan and must be exact.
    M = 16
    C = (1 << M) - 1
    # (a = 7 and a = C-2 refuse: their splits need v in {7, 2})
    for a in (32, 37, 41, 43):
        if math.gcd(a, C) != 1:
            continue
        _check(C, pow(a, -1, C), M, require_plan=True)
    assert plan_stride_permute(C, pow(7, -1, C), M) is None


def test_negation_only_case():
    # a_inv = C - 1 : eps = -1, u = v = 1 — pure index reversal.
    M = 14
    C = (1 << M) - 3
    assert math.gcd(C - 1, C) == 1
    assert _check(C, C - 1, M, require_plan=True)


def test_single_leg_cases():
    M = 16
    C = (1 << M) - 15
    # small a_inv: u = a_inv, v = 1 (deal leg only)
    a_inv = 197
    assert math.gcd(a_inv, C) == 1
    plan = plan_stride_permute(C, a_inv, M)
    assert plan is not None and plan.v == 1 and plan.u == a_inv
    _check(C, a_inv, M, require_plan=True)
    # a_inv = inverse of a small v: the split may pick either a pure
    # collect leg or a cheaper balanced pair — parity must hold either way
    v = 311
    assert math.gcd(v, C) == 1
    a_inv = pow(v, -1, C)
    _check(C, a_inv, M, require_plan=True)


def test_shor_power_sequence():
    """The actual per-step multipliers of a semiclassical attempt:
    a_inv_s = (a^(2^s))^{-1} mod C.  The tiny-power steps (a^1, a^2,
    a^4 for a=2 — split v in {2,4,16}, catastrophic tiling) refuse and
    fall back to the gather; the generic big-exponent steps must plan."""
    M = 18
    C = 251 * 1013  # odd semiprime just below 2^18
    assert C < (1 << M)
    a = 2
    eligible = planned = 0
    for s in range(12):
        a_inv = pow(pow(a, 1 << s, C), -1, C)
        if a_inv <= 1:
            continue
        eligible += 1
        planned += _check(C, a_inv, M, require_plan=False)
    assert planned >= (2 * eligible) // 3, (planned, eligible)


def test_identity_tail_preserved():
    M = 16
    C = (1 << M) - (1 << 12) - 1  # big identity tail
    a = 1234577 % C
    assert math.gcd(a, C) == 1
    a_inv = pow(a, -1, C)
    plan = plan_stride_permute(C, a_inv, M)
    assert plan is not None
    x = np.arange(2 * (1 << M), dtype=np.float32).reshape(2, -1)
    got = np.asarray(apply_stride_permute(jnp.asarray(x), plan))
    np.testing.assert_array_equal(got[:, C:], x[:, C:])
    np.testing.assert_array_equal(got, _ref_permute(x, C, a_inv, M))


def test_bf16_and_flat_shapes():
    M = 14
    C = (1 << M) - 3
    a_inv = pow(5, -1, C)
    plan = plan_stride_permute(C, a_inv, M)
    if plan is None:
        pytest.skip("below slice-width floor")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1 << M,)).astype(np.float32)
    want = _ref_permute(x, C, a_inv, M)
    got32 = np.asarray(apply_stride_permute(jnp.asarray(x), plan))
    np.testing.assert_array_equal(got32, want)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gotb = np.asarray(apply_stride_permute(xb, plan).astype(jnp.float32))
    np.testing.assert_array_equal(
        gotb, np.asarray(xb.astype(jnp.float32))[..., np.asarray(
            modmul_inverse_permutation(C, pow(a_inv, -1, C), M))]
    )


@pytest.mark.parametrize("M", [14, 16])
def test_fuzz_parity_planned_multipliers(M):
    """Walks multipliers until several genuinely plan (small M refuses
    most); parity must be exact through both legs and the negation."""
    C = (1 << M) - 3
    planned = 0
    for a in range(3, 4000, 2):
        if math.gcd(a, C) != 1:
            continue
        a_inv = pow(a, -1, C)
        if a_inv <= 1:
            continue
        planned += _check(C, a_inv, M, require_plan=False)
        if planned >= 3:
            break
    assert planned >= 3  # the structured path must actually be exercised


@pytest.mark.parametrize(
    "M,C,u,W",
    [
        (16, 65533, 509, 128),    # straddling chunk wrap
        (16, 65280, 131, 256),    # C % W == 0: no straddle, tail exact
        (17, 131063, 257, 256),   # wider rows, odd u
        (15, 32765, 129, 128),
        (12, 4093, 3, 1024),      # tiny u, wide chunks
    ],
)
def test_deal_leg_matches_element_map(M, C, u, W):
    """_deal_leg parity against the element map out[j] = x[(u*j) mod C]
    (j < C), identity above, at shapes where C % W varies."""
    from quantumcomputer.ops.modperm import _deal_leg

    assert W * u <= C <= (1 << M)
    rng = np.random.default_rng(u)
    x = rng.standard_normal((2, 1 << M)).astype(np.float32)
    got = np.asarray(_deal_leg(jnp.asarray(x), C, u, M, W))
    j = np.arange(1 << M)
    src = np.where(j < C, (u * j) % C, j)
    np.testing.assert_array_equal(got, x[:, src], err_msg=f"u={u} C={C}")


@pytest.mark.parametrize("v", [3, 43, 127, 128, 129, 899])
def test_collect_leg_matches_element_map(v):
    """_collect_leg parity against out[j] = x[(v^-1 * j) mod C] (j < C),
    identity above — row widths Qpv = ceil(C/v) both lane-aligned and
    not (the cyclic extension covers the rounding surplus)."""
    from quantumcomputer.ops.modperm import _collect_leg

    M = 14
    C = (1 << M) - 3
    if math.gcd(v, C) != 1:
        pytest.skip("v shares a factor with C")
    vinv = pow(v, -1, C)
    rng = np.random.default_rng(v)
    x = rng.standard_normal((2, 1 << M)).astype(np.float32)
    got = np.asarray(_collect_leg(jnp.asarray(x), C, v, vinv, M))
    j = np.arange(1 << M)
    src = np.where(j < C, (vinv * j) % C, j)
    np.testing.assert_array_equal(got, x[:, src], err_msg=f"v={v}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
def test_legs_exact_for_dtype_and_batch(dtype, B):
    """Both legs and the negation are pure data movement: exact for every
    dtype and for leading batch dims (one plane or both)."""
    from quantumcomputer.ops.modperm import _collect_leg, _deal_leg, _negate_mod

    M, C = 13, 8189
    rng = np.random.default_rng(B)
    x = jnp.asarray(rng.standard_normal((B, 1 << M)), dtype)
    xs = np.asarray(x.astype(jnp.float32))
    j = np.arange(1 << M)
    vinv = pow(61, -1, C)
    for got, src in (
        (_deal_leg(x, C, 67, M, 64), np.where(j < C, (67 * j) % C, j)),
        (_collect_leg(x, C, 61, vinv, M), np.where(j < C, (vinv * j) % C, j)),
        (_negate_mod(x, C), np.where(j < C, (-j) % C, j)),
    ):
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(np.asarray(got.astype(jnp.float32)), xs[:, src])
