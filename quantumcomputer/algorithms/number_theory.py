"""Exact-integer classical number theory for Shor's algorithm.

Reproduces the classical post-processing layer of the reference
(qc_shor.c:756-964) with the precision bugs fixed:

  * the reference computes integer powers through double ``pow()``
    (INT_POW, qc_shor.c:158-159), silently losing precision beyond 2**53 —
    here every power test uses exact square-and-multiply modular
    exponentiation;
  * the reference's continued-fraction expansion (qc_shor.c:806-846) is
    reproduced coefficient-for-coefficient, including its convention of
    deriving each coefficient as ``floor(1/omega)`` and rebuilding the
    convergent denominators from the coefficient array in reverse.

A C++ implementation of the same functions is available via
:mod:`quantumcomputer.algorithms._native`; these pure-Python versions are
the reference semantics and the fallback.
"""

from __future__ import annotations

import math
from typing import List

# Continued-fraction search depth, mirroring the reference's compile-time
# constants (qc_shor.c:121-122) — but runtime-tunable here (the reference
# lists this as a limitation, qc_shor.c:58-61).
NUM_CONTINUED_FRACTIONS = 15
TRIALS_PER_DENOMINATOR = 10


def gcd(a: int, b: int) -> int:
    """Greatest common divisor (iterative Euclid, qc_shor.c:756-779)."""
    a, b = abs(int(a)), abs(int(b))
    while b:
        a, b = b, a % b
    return a


def modpow(base: int, exp: int, mod: int) -> int:
    """Exact a**x mod m by square-and-multiply.

    Replaces the reference's INT_POW(a, p) % C (qc_shor.c:946), which
    round-trips through a double and is wrong once a**p exceeds 2**53.
    """
    if mod <= 0:
        raise ValueError("modulus must be positive")
    return pow(int(base), int(exp), int(mod))


def modinv(a: int, m: int) -> int:
    """Modular inverse of a mod m; requires gcd(a, m) == 1."""
    g = gcd(a, m)
    if g != 1:
        raise ValueError(f"{a} has no inverse mod {m} (gcd={g})")
    return pow(int(a), -1, int(m))


def continued_fraction_denominators(omega: float, num_fractions: int = NUM_CONTINUED_FRACTIONS) -> List[int]:
    """Denominators of successive continued-fraction convergents of omega.

    Semantics match qc_shor.c:806-846: at each iteration i, take
    omega_inv = 1/omega, the next omega is its fractional part, the
    coefficient is the integer part, and the i-th denominator is rebuilt
    from coefficients [0..i-1] in reverse.  For omega == 0 the reference
    divides by zero (omega_inv = inf) — we emit denominator 1 and stop
    refining, which reproduces the downstream behavior (the d=1 candidates
    are tried first).
    """
    denominators: List[int] = []
    coeffs: List[int] = []
    for _ in range(num_fractions):
        if omega <= 0.0:
            # Degenerate measurement (x_tilde == 0).  1/omega is not
            # representable; every further convergent is the same.
            coeffs.append(0)
        else:
            omega_inv = 1.0 / omega
            frac = omega_inv - float(int(omega_inv))
            coeffs.append(int(omega_inv - frac))
            omega = frac
        # Rebuild convergent numerator/denominator from coeffs[:-1] reversed,
        # exactly as the reference does (qc_shor.c:834-840).
        denominator, numerator = 1, 0
        for c in reversed(coeffs[:-1]):
            numerator, denominator = denominator, numerator + denominator * c
        denominators.append(denominator)
    return denominators


def find_period_from_omega(
    omega: float,
    a: int,
    C: int,
    num_fractions: int = NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = TRIALS_PER_DENOMINATOR,
    use_native: bool = True,
) -> int | None:
    """Classical period extraction from a measured frequency omega.

    Tries multiples m*d (m = 1..trials) of each continued-fraction
    denominator d against the validity condition a**p ≡ 1 (mod C)
    (qc_shor.c:941-955).  Returns the period, or None when no candidate
    passes — the reference reads uninitialized memory in that case
    (qc_shor.c:915/959); here it is an explicit miss.

    Dispatches to the native C++ implementation (native/qc_classical.cpp)
    when available and the operands fit u64; the pure-Python path below is
    the reference semantics and the fallback.
    """
    if use_native and 0 < C < (1 << 32) and 0 < a < (1 << 32) and num_fractions <= 64:
        from quantumcomputer.algorithms import _native

        if _native.available():
            return _native.find_period_from_omega(omega, a, C, num_fractions, trials_per_denominator)
    for d in continued_fraction_denominators(omega, num_fractions):
        if d == 0:
            continue
        for m in range(1, trials_per_denominator + 1):
            p = m * d
            if p > 0 and modpow(a, p, C) == 1:
                return p
    return None


def multiplicative_order(a: int, C: int) -> int | None:
    """Exact multiplicative order of a mod C (ground truth for tests)."""
    if gcd(a, C) != 1:
        return None
    x, p = a % C, 1
    while x != 1:
        x = (x * a) % C
        p += 1
        if p > C:  # pragma: no cover - cannot happen for gcd==1
            return None
    return p


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def min_M_for(C: int) -> int:
    """Smallest M with 2**M >= C (cf. the warning at qc_shor.c:343-345)."""
    return max(1, math.ceil(math.log2(C)))


def recommended_L_for(C: int) -> int:
    """Smallest L with 2**L >= C**2 (cf. the warning at qc_shor.c:347-350)."""
    return max(1, math.ceil(math.log2(C * C)))
