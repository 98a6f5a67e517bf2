"""Structured-oracle semiclassical attempt (algorithms/semiclassical.py
_attempt_fn_structured): branch-probability parity against the gather
path, fallback coverage, and the policy guards."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms import semiclassical as sc
from quantumcomputer.algorithms.semiclassical import run_semiclassical


def _branch_parity(C, L, M, a, forced_bits, dtype=jnp.complex64, rtol=1e-6):
    key = jax.random.PRNGKey(0)
    r_g = run_semiclassical(C, a, L, M, key, dtype, forced_bits=forced_bits,
                            structured=False)
    r_s = run_semiclassical(C, a, L, M, key, dtype, forced_bits=forced_bits,
                            structured=True, _cache={})
    assert r_s.bits == list(forced_bits) == r_g.bits
    np.testing.assert_allclose(r_s.branch_probs, r_g.branch_probs, rtol=rtol)
    assert r_s.x_tilde == r_g.x_tilde


def test_branch_parity_with_real_plans():
    """M large enough that the stride-permutation plans exist (C near
    2^M): every structured step runs the modperm path."""
    M = 14
    C = 251 * 61  # 15311 < 16384, odd semiprime
    assert C < (1 << M)
    L, a = 10, 2
    # verify at least some steps really plan (not all-fallback)
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    plans = sc._structured_plans(C, a_invs, M)
    assert sum(p is not None for p in plans) >= L // 2
    rng = np.random.default_rng(0)
    for _ in range(3):
        bits = [int(b) for b in rng.integers(0, 2, size=L)]
        _branch_parity(C, L, M, a, bits)


def test_branch_parity_small_modulus_fallback():
    """C far below 2^M: plans mostly refuse (collect rows under the DMA
    floor) and the structured attempt runs its static-scalar gather
    fallback steps — the program form still differs from structured=False
    (unrolled vs fori_loop), so parity is a real check."""
    C, L, M, a = 391, 8, 9, 3
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    assert any(p is None for p in sc._structured_plans(C, a_invs, M))
    rng = np.random.default_rng(1)
    bits = [int(b) for b in rng.integers(0, 2, size=L)]
    _branch_parity(C, L, M, a, bits)


def test_sampled_run_and_period_e2e():
    from quantumcomputer.algorithms.semiclassical import (
        find_period_semiclassical,
    )

    period, rec = find_period_semiclassical(
        15311, 2, 16, 14, jax.random.PRNGKey(3), structured=True
    )
    assert all(b in (0, 1) for b in rec.bits)
    assert all(0.0 < p <= 1.0 + 1e-6 for p in rec.branch_probs)
    if period is not None:
        assert pow(2, period, 15311) == 1


def test_complex32_branch_parity():
    M = 14
    C = 251 * 61
    L, a = 6, 2
    bits = [1, 0, 1, 1, 0, 0]
    _branch_parity(C, L, M, a, bits, dtype="complex32", rtol=2e-2)


def test_structured_checkpoint_matches_plain(tmp_path):
    """An uninterrupted segmented run (structured + checkpoint_dir) is
    bit-identical to the whole-attempt structured program, and cleans up
    its snapshot directory on completion."""
    import os

    C, a, L, M = 15311, 2, 8, 14
    key = jax.random.PRNGKey(5)
    ref = run_semiclassical(C, a, L, M, key, structured=True, _cache={})
    ckdir = str(tmp_path / "ck")
    rec = run_semiclassical(
        C, a, L, M, key, structured=True,
        checkpoint_dir=ckdir, checkpoint_every=3, _cache={},
    )
    assert rec.bits == ref.bits
    np.testing.assert_allclose(rec.branch_probs, ref.branch_probs, rtol=1e-6)
    assert not [d for d in os.listdir(ckdir) if d.startswith("sc_")] if os.path.isdir(ckdir) else True


def test_structured_checkpoint_kill_and_resume(tmp_path):
    """A segmented structured attempt killed mid-run resumes from the
    last segment snapshot with NO re-measure: identical record, and the
    resumed process executes only the remaining segments (VERDICT r3 #5 —
    the headline-class run's path must survive preemption)."""
    C, a, L, M = 15311, 2, 8, 14
    key = jax.random.PRNGKey(3)
    ref = run_semiclassical(C, a, L, M, key, structured=True, _cache={})

    ckdir = str(tmp_path / "ck")
    real = sc._attempt_fn_structured_segment
    calls = {"n": 0, "die_after": None}

    def counting(Lv, Mv, rdtype, Cv, av, s0, s1):
        seg = real(Lv, Mv, rdtype, Cv, av, s0, s1)

        def wrapped(*args):
            calls["n"] += 1
            if calls["die_after"] is not None and calls["n"] > calls["die_after"]:
                raise KeyboardInterrupt("simulated preemption")
            return seg(*args)

        return wrapped

    sc._attempt_fn_structured_segment = counting
    try:
        # Segments with checkpoint_every=3: [0,3), [3,6), [6,8).  Die on
        # the second — the snapshot at step 3 is on disk.
        calls.update(n=0, die_after=1)
        with pytest.raises(KeyboardInterrupt):
            run_semiclassical(C, a, L, M, key, structured=True,
                              checkpoint_dir=ckdir, checkpoint_every=3, _cache={})
        calls.update(n=0, die_after=None)
        rec = run_semiclassical(C, a, L, M, key, structured=True,
                                checkpoint_dir=ckdir, checkpoint_every=3, _cache={})
        assert calls["n"] == 2  # [3,6) and [6,8) only
        assert rec.bits == ref.bits
        np.testing.assert_allclose(rec.branch_probs, ref.branch_probs, rtol=1e-6)
        assert rec.x_tilde == ref.x_tilde
    finally:
        sc._attempt_fn_structured_segment = real


@pytest.mark.parametrize("structured", [True, False])
def test_structured_argument_selects_path(structured):
    """structured=True/False pins the oracle path whatever the default."""
    cache = {}
    run_semiclassical(391, 3, 4, 9, jax.random.PRNGKey(0), structured=structured, _cache=cache)
    assert any(isinstance(k, tuple) and k[0] == "structured" for k in cache) is structured


@pytest.mark.parametrize("C,a,L,M", [(15311, 2, 4, 14), (391, 3, 4, 9)])
def test_default_is_the_gather_path(C, a, L, M):
    """The default keeps the compile-once gather programs at every M: the
    structured attempt's per-(C, a) compile costs more than its faster
    steps save in one attempt."""
    cache = {}
    run_semiclassical(C, a, L, M, jax.random.PRNGKey(0), _cache=cache)
    assert not any(isinstance(k, tuple) and k[0] == "structured" for k in cache)


def test_cache_lru_bounded():
    cache = {}
    for i, C in enumerate([15311, 15313 * 1 - 2, 15307, 15289, 15287,
                           15277, 15271, 15259, 15255, 15251]):
        if math.gcd(2, C) != 1 or C % 2 == 0:
            continue
        run_semiclassical(
            C, 2, 3, 14, jax.random.PRNGKey(i), structured=True, _cache=cache
        )
    n = sum(1 for k in cache if isinstance(k, tuple) and k[0] == "structured")
    assert n <= 8


def test_segment_cache_keeps_own_attempt(tmp_path, monkeypatch):
    """ADVICE r4: the segment-program cache must never evict segments of
    the RUNNING attempt (pre-fix: FIFO with a flat 32-key cap, so an
    attempt spanning >32 segments recompiled its own programs), and a
    re-run of the same attempt must be all cache hits (LRU, not FIFO)."""
    calls = []
    orig = sc._attempt_fn_structured_segment

    def counting(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(sc, "_attempt_fn_structured_segment", counting)
    cache = {}
    C, a, L, M = 1021, 2, 36, 10
    key = jax.random.PRNGKey(3)
    ref = run_semiclassical(C, a, L, M, key, structured=True, _cache={})
    got = run_semiclassical(
        C, a, L, M, key, structured=True,
        checkpoint_dir=str(tmp_path), checkpoint_every=1, _cache=cache,
    )
    assert got.bits == ref.bits and got.x_tilde == ref.x_tilde
    segs = [k for k in cache if isinstance(k, tuple) and k[0] == "structured-seg"]
    assert len(segs) == 36 and len(calls) == 36
    # Same attempt again: every segment program is a hit — zero compiles.
    run_semiclassical(
        C, a, L, M, key, structured=True,
        checkpoint_dir=str(tmp_path), checkpoint_every=1, _cache=cache,
    )
    assert len(calls) == 36
