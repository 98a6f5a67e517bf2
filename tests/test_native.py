"""Native C++ classical layer vs the pure-Python reference semantics.

The shared library is built on demand by the ctypes loader; if no compiler
is available the whole module is skipped (the Python path is the fallback
and is tested in test_number_theory.py)."""

import math

import numpy as np
import pytest

from quantumcomputer.algorithms import _native
from quantumcomputer.algorithms import number_theory as nt

pytestmark = pytest.mark.skipif(not _native.available(), reason="native library unavailable")


def test_gcd_matches():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = int(rng.integers(0, 1 << 62))
        b = int(rng.integers(0, 1 << 62))
        assert _native.gcd(a, b) == math.gcd(a, b)


def test_modpow_matches():
    rng = np.random.default_rng(1)
    for _ in range(200):
        b = int(rng.integers(0, 1 << 32))
        e = int(rng.integers(0, 1 << 32))
        m = int(rng.integers(1, 1 << 32))
        assert _native.modpow(b, e, m) == pow(b, e, m)


def test_cf_denominators_match_python():
    # Every dyadic omega that can be measured with L <= 8.
    for L in (3, 5, 8):
        for x in range(1 << L):
            omega = x / (1 << L)
            got = _native.continued_fraction_denominators(omega, 15)
            want = nt.continued_fraction_denominators(omega, 15)
            # Compare modulo u64 wrap (the Python path has exact big ints;
            # agreement is required wherever the C path hasn't wrapped).
            for g, w in zip(got, want):
                if w < (1 << 64):
                    assert g == w, (omega, got, want)


def test_find_period_matches_python():
    cases = [(0.25, 7, 15), (0.75, 7, 15), (0.0, 7, 15), (53 / 128, 2, 35), (0.123456789, 11, 21)]
    for omega, a, C in cases:
        got = _native.find_period_from_omega(omega, a, C, 15, 10)
        want = nt.find_period_from_omega(omega, a, C, use_native=False)
        assert got == want, (omega, a, C)


def test_mult_order_matches():
    for C in (15, 21, 33, 35, 39):
        for a in range(2, C):
            want = nt.multiplicative_order(a, C)
            got = _native.multiplicative_order(a, C)
            assert got == want or (want is None and got is None), (a, C)


def test_cycle_schedule_native_matches_python():
    from quantumcomputer.algorithms import _native
    from quantumcomputer.ops.gates import modmul_inverse_permutation

    if not _native.available():
        pytest.skip("native library unavailable")
    import numpy as np

    for C, A, M in [(15, 7, 4), (251, 13, 8), (8191, 3, 13)]:
        ginv = np.asarray(modmul_inverse_permutation(C, A, M), np.int32)
        o1, s1, k1 = _native.cycle_schedule(ginv)
        # Python reference walk of the same cycle schedule
        rows = len(ginv)
        visited = np.zeros(rows, bool)
        o2 = np.empty(rows, np.int32); s2 = np.empty(rows, np.int32); k2 = np.empty(rows, np.int32)
        t = 0
        for j0 in range(rows):
            if visited[j0]:
                continue
            if ginv[j0] == j0:
                o2[t], s2[t], k2[t] = j0, j0, 2
                visited[j0] = True
                t += 1
                continue
            j, first = j0, True
            while not visited[j]:
                visited[j] = True
                o2[t], s2[t], k2[t] = j, ginv[j], 1 if first else 0
                first = False
                t += 1
                j = int(ginv[j])
            k2[t - 1] = 3  # cycle-closing step (in-place head-slot source)
        assert np.array_equal(o1, o2) and np.array_equal(s1, s2) and np.array_equal(k1, k2)


def test_combo_multipliers_native_matches_python():
    from quantumcomputer.algorithms import _native

    if not _native.available():
        pytest.skip("native library unavailable")
    import numpy as np

    C = 8191
    A = [pow(3, 1 << k, C) for k in range(5)]
    got = _native.combo_multipliers(C, A)
    want = np.ones(32, np.int64)
    for mask in range(1, 32):
        v = 1
        for k in range(5):
            if (mask >> k) & 1:
                v = (v * pow(A[k], -1, C)) % C
        want[mask] = v
    assert np.array_equal(got.astype(np.int64), want)
    # non-invertible multiplier -> None
    assert _native.combo_multipliers(12, [4]) is None


def test_dispatch_uses_native():
    # The public API must produce identical results with and without native.
    assert nt.find_period_from_omega(0.25, 7, 15, use_native=True) == 4
    assert nt.find_period_from_omega(0.25, 7, 15, use_native=False) == 4
