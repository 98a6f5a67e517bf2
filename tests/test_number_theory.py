"""Classical layer: gcd, modpow, continued fractions, period extraction.

Oracles: exact integer arithmetic; the Candela continued-fraction example;
multiplicative-order ground truth."""

import math

import pytest

from quantumcomputer.algorithms import number_theory as nt


def test_gcd_matches_math():
    for a in range(0, 50):
        for b in range(0, 50):
            assert nt.gcd(a, b) == math.gcd(a, b)


def test_modpow_exact_beyond_double():
    # The reference's INT_POW(a, p) % C loses precision beyond 2**53
    # (qc_shor.c:158-159, 946); ours must not.
    a, p, C = 7, 100, 15
    assert nt.modpow(a, p, C) == pow(7, 100, 15)
    assert nt.modpow(3, 10_000, 1_000_003) == pow(3, 10_000, 1_000_003)


def test_modinv():
    for C in (15, 21, 33, 35, 39):
        for a in range(2, C):
            if math.gcd(a, C) == 1:
                assert (a * nt.modinv(a, C)) % C == 1


def test_continued_fractions_convergent_denominators():
    # omega = 3/8: exact CF is [0; 2, 1, 2], but the reference's
    # double-precision recurrence (qc_shor.c:821-843) drifts 1/(2/3) just
    # above 1.5 and expands [2, 1, 1, 1, ...] instead — denominators
    # 1, 2, 3, 5, 8 (Fibonacci).  We reproduce that semantics exactly.
    d = nt.continued_fraction_denominators(3 / 8, 5)
    assert d[:5] == [1, 2, 3, 5, 8]


def test_continued_fractions_recovers_large_period():
    # Realistic measured omega is dyadic: x_tilde / 2^L.  For C=35, a=2
    # (period 12 > the 10-multiple sweep), the harmonic 5/12 measured at
    # L=7 resolution is 53/128; denominator 12 must appear as a convergent
    # and the period test must recover it.
    d = nt.continued_fraction_denominators(53 / 128, 8)
    assert 12 in d
    assert nt.find_period_from_omega(53 / 128, 2, 35) == 12


def test_continued_fractions_quarter():
    d = nt.continued_fraction_denominators(0.25, 3)
    assert d[0] == 1 and d[1] == 4


def test_continued_fractions_zero_omega():
    # Degenerate measurement x_tilde = 0 must not crash (reference divides
    # by zero here).
    d = nt.continued_fraction_denominators(0.0, 4)
    assert d[0] == 1
    assert all(x in (0, 1) for x in d)  # zero denominators are skipped downstream


def test_find_period_from_omega():
    # C=15, a=7 has period 4; omega = 1/4 must recover it.
    assert nt.find_period_from_omega(0.25, 7, 15) == 4
    # omega = 3/4: denominator 4 appears as a convergent of 3/4.
    assert nt.find_period_from_omega(0.75, 7, 15) == 4
    # omega = 0: period 4 is a multiple of denominator 1 within 10 trials.
    assert nt.find_period_from_omega(0.0, 7, 15) == 4


def test_find_period_miss_returns_none():
    # a=2, C=21 has order 6; an omega unrelated to any divisor structure
    # with tiny search depth must miss.
    assert nt.find_period_from_omega(0.123456789, 11, 21, num_fractions=1, trials_per_denominator=1) is None


def test_multiplicative_order():
    assert nt.multiplicative_order(7, 15) == 4
    assert nt.multiplicative_order(2, 21) == 6
    assert nt.multiplicative_order(7, 33) == 10
    assert nt.multiplicative_order(3, 15) is None  # gcd > 1


def test_register_size_helpers():
    assert nt.min_M_for(15) == 4
    assert nt.recommended_L_for(15) == 8
