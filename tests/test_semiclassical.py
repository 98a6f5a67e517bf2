"""Semiclassical (one-control-qubit) period finding: n = M + 1 qubits.

Correctness oracle: the FULL-register engine.  The semiclassical scheme is
the reference circuit with the iQFT's controlled phases deferred onto
their lower qubits and evaluated classically after measurement — so the
joint distribution over measured counting bits must EQUAL the full
circuit's counting-register distribution, branch by branch.  That is
tested exactly (every branch, 1e-6 at complex64), not statistically.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.semiclassical import (
    find_period_semiclassical,
    run_semiclassical,
)
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _full_register_omega_distribution(C, a, L, M):
    """P(x_tilde) from the full-register circuit: marginalize the final
    state's probabilities over the work register, then bit-reverse the
    counting index (read_omega convention)."""
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    state = eng.run(shor_circuit(C, a, L, M))
    amps = eng.to_numpy(state)
    probs = np.abs(amps) ** 2
    p_count = probs.reshape(1 << L, 1 << M).sum(axis=1)  # index = counting bits [M, N)
    # counting value c (bits M..N-1, LSB-first within the register) ->
    # x_tilde = bit-reversed c
    p_xt = np.zeros(1 << L)
    for c in range(1 << L):
        xt = int(format(c, f"0{L}b")[::-1], 2) if L > 1 else c
        p_xt[xt] += p_count[c]
    return p_xt


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5), (33, 29, 3, 6)])
def test_branch_distribution_equals_full_circuit(C, a, L, M):
    """EVERY measurement branch's joint probability (product of recorded
    conditionals) equals the full-register probability of that x_tilde."""
    p_xt = _full_register_omega_distribution(C, a, L, M)
    total = 0.0
    for branch in range(1 << L):
        forced = [(branch >> k) & 1 for k in range(L)]  # m_{L-1}.. in order
        rec = run_semiclassical(
            C, a, L, M, jax.random.PRNGKey(0), dtype=jnp.complex64, forced_bits=forced
        )
        # joint probability, short-circuiting dead branches (forcing a
        # zero-probability outcome leaves NaNs downstream by construction)
        p = 1.0
        for cond in rec.branch_probs:
            if not np.isfinite(cond) or cond < 1e-12:
                p = 0.0
                break
            p *= cond
        if p > 0.0:
            assert rec.x_tilde == branch
        assert abs(p - p_xt[branch]) < 1e-6, (branch, p, p_xt[branch])
        total += p
    assert abs(total - 1.0) < 1e-6


def test_sampled_runs_land_on_support():
    C, a, L, M = 15, 7, 3, 4
    p_xt = _full_register_omega_distribution(C, a, L, M)
    support = {i for i in range(1 << L) if p_xt[i] > 1e-9}
    for seed in range(12):
        rec = run_semiclassical(C, a, L, M, jax.random.PRNGKey(seed))
        assert rec.x_tilde in support
        assert abs(rec.omega - rec.x_tilde / (1 << L)) < 1e-15


def test_find_period_semiclassical_factors():
    """End-to-end: period recovery via CF on the semiclassical omega."""
    found = 0
    for seed in range(8):
        period, rec = find_period_semiclassical(15, 7, 3, 4, jax.random.PRNGKey(seed))
        if period is not None:
            assert period == 4
            found += 1
    assert found >= 4  # half the omega mass lies on period-revealing harmonics

    period, _ = find_period_semiclassical(21, 2, 5, 5, jax.random.PRNGKey(3))
    assert period in (None, 6)


def test_semiclassical_qubit_budget():
    """The whole point: C=8191-scale moduli run on an (M+1)-qubit state.
    One attempt at M=13 uses 2^14 amplitudes (the full-register circuit
    needs 2^30 at L=17)."""
    C, a, M = 8191, 3, 13
    L = 17
    period, rec = find_period_semiclassical(C, a, L, M, jax.random.PRNGKey(1))
    assert len(rec.bits) == L
    if period is not None:
        # a=3 has multiplicative order 13 mod 8191 — tiny, so CF usually
        # nails it despite 2^L >> C not holding confidence-wise
        assert pow(a, period, C) == 1


def test_semiclassical_rejects_undersized_M():
    with pytest.raises(ValueError, match="not unitary"):
        run_semiclassical(15, 7, 3, 3, jax.random.PRNGKey(0))


def test_semiclassical_bounds():
    with pytest.raises(ValueError, match="int32"):
        run_semiclassical(15, 7, 3, 31, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mantissa"):
        run_semiclassical(15, 7, 53, 4, jax.random.PRNGKey(0))


def test_forced_bits_length_mismatch_raises():
    """forced_bits shorter (or longer) than L must raise: inside the fused
    fori_loop an out-of-bounds forces[s] gather CLAMPS to the last entry —
    a short list would silently force the tail steps instead of erroring.
    All engines (fused, per-step, sharded) share the same contract."""
    with pytest.raises(ValueError, match="forced_bits"):
        run_semiclassical(15, 7, 4, 4, jax.random.PRNGKey(0), forced_bits=[1, 0, 1])
    with pytest.raises(ValueError, match="forced_bits"):
        run_semiclassical(
            15, 7, 4, 4, jax.random.PRNGKey(0), forced_bits=[0] * 5, fused=False
        )
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded_semiclassical import (
        run_semiclassical_sharded,
    )

    mesh = build_mesh(2)
    with pytest.raises(ValueError, match="forced_bits"):
        run_semiclassical_sharded(
            15, 7, 4, 4, jax.random.PRNGKey(0), mesh, forced_bits=[1]
        )


def test_semiclassical_checkpoint_typed_prng_key(tmp_path):
    """jax.random.key (typed PRNG keys) must work WITH checkpointing: the
    fingerprint hashes the raw key data (np.asarray on a typed key raises
    TypeError), and the record must match the legacy-key run bit for bit
    (same key data -> same draws)."""
    C, a, L, M = 15, 7, 5, 4
    rec_typed = run_semiclassical(
        C, a, L, M, jax.random.key(7), checkpoint_dir=str(tmp_path / "ck"), _cache={}
    )
    rec_legacy = run_semiclassical(C, a, L, M, jax.random.PRNGKey(7), fused=False)
    assert rec_typed.bits == rec_legacy.bits
    assert rec_typed.x_tilde == rec_legacy.x_tilde


def test_semiclassical_checkpoint_dir_cleaned_after_attempt(tmp_path):
    """A completed attempt removes its own per-attempt snapshot subdir, so
    a trial loop's checkpoint_dir does not grow without bound (each
    snapshot is a full 2^M-amplitude state)."""
    import os

    ckdir = tmp_path / "ck"
    run_semiclassical(
        21, 2, 8, 5, jax.random.PRNGKey(3),
        checkpoint_dir=str(ckdir), checkpoint_every=2, _cache={},
    )
    leftovers = [d for d in os.listdir(ckdir)] if ckdir.is_dir() else []
    assert leftovers == []


def test_modmul_indices_onchip_matches_host_table():
    """The device-side shift-add index generator must equal the int64 host
    table for every modulus class (odd/even a_inv, C near 2^M, tiny C)."""
    from quantumcomputer.ops.gates import (
        modmul_inverse_indices_onchip,
        modmul_inverse_permutation,
    )

    cases = [(15, 7, 4), (21, 2, 5), (33, 29, 6), (8191, 3, 13), (1019 * 1021, 2, 20),
             (63, 62, 6), (5, 2, 10)]
    for C, A, M in cases:
        a_inv = pow(A % C, -1, C)
        host = modmul_inverse_permutation(C, A, M)
        dev = jax.jit(
            lambda c, ai: modmul_inverse_indices_onchip(c, ai, M)
        )(jnp.int32(C), jnp.int32(a_inv))
        np.testing.assert_array_equal(np.asarray(dev), host, err_msg=f"C={C} A={A} M={M}")


def test_per_step_path_matches_fused():
    """The memory-ceiling per-step dispatch path (host-side deferred phase)
    must reproduce the fused fori_loop attempt: same bits with the same
    draws, branch probabilities equal to f32 theta roundoff."""
    C, a, L, M = 21, 2, 5, 5
    for seed in (0, 3, 9):
        key = jax.random.PRNGKey(seed)
        rf = run_semiclassical(C, a, L, M, key, fused=True)
        rp = run_semiclassical(C, a, L, M, key, fused=False)
        assert rf.bits == rp.bits
        np.testing.assert_allclose(rf.branch_probs, rp.branch_probs, atol=2e-6)
    # forced-branch parity too (exact branch weights on both paths)
    forced = [1, 0, 1, 1, 0]
    rf = run_semiclassical(C, a, L, M, jax.random.PRNGKey(0), forced_bits=forced, fused=True)
    rp = run_semiclassical(C, a, L, M, jax.random.PRNGKey(0), forced_bits=forced, fused=False)
    assert rf.bits == rp.bits == forced
    np.testing.assert_allclose(rf.branch_probs, rp.branch_probs, atol=2e-6)


def test_fused_auto_selection_honours_memory_budget(monkeypatch):
    """Auto mode must fall back to per-step dispatch when the fused
    attempt's footprint exceeds the device budget."""
    from quantumcomputer.algorithms import semiclassical as sc

    state_bytes = 2 * (1 << 5) * 4  # one (2, 2^M) work-register state
    monkeypatch.setenv("QC_HBM_BYTES", str(sc._FUSED_STATES_HEADROOM * state_bytes))
    assert sc.fused_attempt_fits(5, jnp.float32)
    monkeypatch.setenv("QC_HBM_BYTES", str(sc._FUSED_STATES_HEADROOM * state_bytes - 1))
    assert not sc.fused_attempt_fits(5, jnp.float32)
    # a 14.5 GiB budget: with the implicit-control work-register state,
    # fused through M=28 (c64) / M=29 (c32); per-step through M=29 (c64) /
    # M=30 (c32).
    monkeypatch.setenv("QC_HBM_BYTES", str(int(14.5 * (1 << 30))))
    assert sc.fused_attempt_fits(28, jnp.float32)
    assert not sc.fused_attempt_fits(29, jnp.float32)
    assert sc.step_program_fits(29, jnp.float32)
    assert not sc.step_program_fits(30, jnp.float32)
    assert sc.fused_attempt_fits(29, jnp.bfloat16)
    assert not sc.fused_attempt_fits(30, jnp.bfloat16)
    assert sc.step_program_fits(30, jnp.bfloat16)
    # the auto path surfaces the ceiling as a clear error (M=4 work state
    # is 128 bytes; a budget under the 3-state per-step floor must refuse)
    monkeypatch.setenv("QC_HBM_BYTES", str(3 * 128 - 1))
    with pytest.raises(ValueError, match="memory budget"):
        sc.run_semiclassical(15, 7, 3, 4, jax.random.PRNGKey(0))


def test_semiclassical_checkpoint_kill_and_resume(tmp_path):
    """A semiclassical attempt killed mid-run resumes from the last
    snapshot with NO re-measure: same bits/probs as an uninterrupted run,
    and the resumed process executes only the remaining steps."""
    from quantumcomputer.algorithms import semiclassical as sc

    C, a, L, M = 21, 2, 8, 5
    key = jax.random.PRNGKey(3)
    ref = run_semiclassical(C, a, L, M, key, fused=False)

    ckdir = str(tmp_path / "ck")
    calls = {"n": 0}
    real_step_fn = sc._step_fn

    def counting_step_fn(Mv, rdtype):
        step = real_step_fn(Mv, rdtype)

        def wrapped(*args):
            calls["n"] += 1
            if calls["die_after"] is not None and calls["n"] > calls["die_after"]:
                raise KeyboardInterrupt("simulated preemption")
            return step(*args)

        return wrapped

    sc._step_fn = counting_step_fn
    try:
        # First run dies after 5 steps (snapshots at 4 with checkpoint_every=4).
        calls.update(n=0, die_after=5)
        with pytest.raises(KeyboardInterrupt):
            run_semiclassical(C, a, L, M, key, checkpoint_dir=ckdir, _cache={})
        # Resume: completes, identical record, only L - 4 steps executed.
        calls.update(n=0, die_after=None)
        rec = run_semiclassical(C, a, L, M, key, checkpoint_dir=ckdir, _cache={})
        assert calls["n"] == L - 4
        assert rec.bits == ref.bits
        np.testing.assert_allclose(rec.branch_probs, ref.branch_probs, atol=1e-6)
        assert rec.x_tilde == ref.x_tilde
        # A DIFFERENT attempt in the same dir must not resume from these
        # snapshots (fingerprint mismatch -> cold start, full step count).
        calls.update(n=0, die_after=None)
        other = run_semiclassical(C, a, L, M, jax.random.PRNGKey(99), checkpoint_dir=ckdir, _cache={})
        assert calls["n"] == L
        ref_other = run_semiclassical(C, a, L, M, jax.random.PRNGKey(99), fused=False)
        assert other.bits == ref_other.bits
    finally:
        sc._step_fn = real_step_fn


def test_semiclassical_checkpoint_corrupt_snapshot_logs_and_restarts(tmp_path):
    """A corrupted snapshot is skipped WITH a log line (never silently
    treated as a cold start) and the attempt still completes correctly.

    Captured with a handler attached directly to the package logger:
    the CLI's configure() sets propagate=False once any CLI test has
    run, so caplog (which listens on the root logger) would miss it."""
    import logging

    from quantumcomputer.algorithms import semiclassical as sc

    C, a, L, M = 15, 7, 5, 4
    key = jax.random.PRNGKey(0)
    ckdir = tmp_path / "ck"
    # Snapshots live in a per-attempt subdir keyed by the fingerprint
    # (sc_<fp>) — plant the corrupt file where this attempt will scan.
    fp = sc._attempt_fingerprint(
        C, a, L, M, jnp.float32, key, np.full((L,), -1, np.int32)
    )
    attempt_dir = ckdir / f"sc_{fp}"
    attempt_dir.mkdir(parents=True)
    (attempt_dir / "segment_00004.npz").write_bytes(b"not a real npz")
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("quantumcomputer.semiclassical")
    handler = _Capture(level=logging.WARNING)
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        rec = run_semiclassical(C, a, L, M, key, checkpoint_dir=str(ckdir), _cache={})
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    assert any("unreadable" in r.getMessage() for r in records)
    ref = run_semiclassical(C, a, L, M, key, fused=False)
    assert rec.bits == ref.bits


def test_modmul_table_large_modulus():
    """The inverse-permutation table must be exact for C > 2^16, where the
    a_inv * f products exceed int32 (int64 host arithmetic)."""
    from quantumcomputer.ops.gates import modmul_inverse_permutation

    C, A, M = 1019 * 1021, 2, 20
    tab = np.asarray(modmul_inverse_permutation(C, A, M))
    a_inv = pow(A, -1, C)
    rng = np.random.default_rng(0)
    for j in map(int, rng.integers(0, C, 64)):
        assert tab[j] == (a_inv * j) % C  # exact Python ints
        # round-trip: g(g_inv(j)) == j
        assert (A * tab[j]) % C == j
    for j in map(int, rng.integers(C, 1 << M, 8)):
        assert tab[j] == j  # identity outside the modulus


def test_semiclassical_large_modulus_end_to_end():
    """Factor a 20-bit semiprime — the full-register circuit would need
    L + M = 60 qubits (2^60 amplitudes, ~18 EB at complex64); the
    semiclassical state is 2^21.  This is the capability the reference's
    architecture caps at ~n=32 (qc_shor.c:68-73)."""
    from quantumcomputer.algorithms.shor import shors_algorithm

    res = shors_algorithm(
        C=1019 * 1021, L=40, M=20, forced_trial_int=2, seed=0, semiclassical=True
    )
    assert res.ok and res.factors == (1021, 1019)
    assert res.attempts[-1].period == 173060


def test_cli_semiclassical_bounds():
    from quantumcomputer.cli import build_parser, validate

    ok = build_parser().parse_args(
        ["-C", "1040399", "-L", "40", "-M", "20", "--semiclassical"]
    )
    assert validate(ok) is None
    big_m = build_parser().parse_args(
        ["-C", "15", "-L", "3", "-M", "31", "--semiclassical"]
    )
    assert "int32" in validate(big_m)
    big_l = build_parser().parse_args(
        ["-C", "15", "-L", "53", "-M", "4", "--semiclassical"]
    )
    assert "mantissa" in validate(big_l)
    # Undersized work register: validate() must catch 2^M < C so the CLI
    # exits with the clean 'Error:' path instead of a raw traceback from
    # run_semiclassical (the full-register mode warns instead; this
    # engine has no warn-and-wrap form).
    small_m = build_parser().parse_args(
        ["-C", "33", "-L", "11", "-M", "5", "--semiclassical"]
    )
    assert "not unitary" in validate(small_m)


def test_shors_algorithm_semiclassical_mode():
    from quantumcomputer.algorithms.shor import shors_algorithm

    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, semiclassical=True)
    assert res.ok and res.factors == (5, 3)
    # trial loop too
    res2 = shors_algorithm(C=21, L=5, M=5, seed=1, semiclassical=True)
    assert res2.ok and res2.factors == (7, 3)


def test_cli_semiclassical(capsys):
    from quantumcomputer.cli import main

    rc = main(["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0", "--semiclassical"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Factors of 15 found: (5, 3)." in out
    # incompatible with m_high / strict-reference (its own engine)
    assert main(["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--layout", "m_high"]) == 2
    # sharded work register needs local rows: M - log2(devices) >= 1
    assert main(["-C", "15", "-L", "3", "-M", "4", "--semiclassical", "--devices", "16"]) == 2


def test_cli_semiclassical_sharded(capsys):
    """--semiclassical --devices N: the work register shards over the mesh
    (parallel/sharded_semiclassical.py) and the driver factors through it."""
    from quantumcomputer.cli import main

    rc = main(
        ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0",
         "--semiclassical", "--devices", "4", "-v"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Factors of 15 found: (5, 3)." in out
    assert "Sharding state vector over 4 device(s)." in out


def test_blockwise_gather_path_matches_direct(monkeypatch):
    """With _GATHER_BLOCK_LOG forced below M, the fori_loop blockwise
    oracle pass (the large-M memory form: index blocks generated on the
    fly, reductions folded in) must reproduce the single-block path —
    the blocks decompose an exact permutation plus elementwise math."""
    from quantumcomputer.algorithms import semiclassical as sc

    C, a, L, M = 33, 29, 4, 6
    key = jax.random.PRNGKey(7)
    ref = run_semiclassical(C, a, L, M, key, fused=False, _cache={})
    monkeypatch.setattr(sc, "_GATHER_BLOCK_LOG", 3)
    blk = run_semiclassical(C, a, L, M, key, fused=False, _cache={})
    assert blk.bits == ref.bits
    np.testing.assert_allclose(blk.branch_probs, ref.branch_probs, rtol=1e-5)
    fused = run_semiclassical(C, a, L, M, key, fused=True, _cache={})
    assert fused.bits == ref.bits
    np.testing.assert_allclose(fused.branch_probs, ref.branch_probs, rtol=1e-5)


def test_complex32_branch_distribution_parity():
    """complex32 (bf16 storage, f32 angle/probability arithmetic): every
    branch's joint probability matches the full-register distribution to
    bf16 storage tolerance, and branches compose to a distribution."""
    C, a, L, M = 15, 7, 3, 4
    p_xt = _full_register_omega_distribution(C, a, L, M)
    total = 0.0
    for branch in range(1 << L):
        forced = [(branch >> k) & 1 for k in range(L)]
        rec = run_semiclassical(
            C, a, L, M, jax.random.PRNGKey(0), dtype="complex32", forced_bits=forced
        )
        p = 1.0
        for cond in rec.branch_probs:
            if not np.isfinite(cond) or cond < 1e-6:
                p = 0.0
                break
            p *= float(cond)
        assert abs(p - p_xt[branch]) < 3e-2, (branch, p, p_xt[branch])
        total += p
    assert abs(total - 1.0) < 5e-2


def test_complex32_semiclassical_end_to_end():
    """The complex32 engine still recovers the period through the full
    CF pipeline (the point: half the HBM of c64 at the same M)."""
    found = 0
    for seed in range(8):
        period, rec = find_period_semiclassical(
            15, 7, 3, 4, jax.random.PRNGKey(seed), dtype="complex32"
        )
        assert len(rec.bits) == 3
        if period is not None:
            assert period == 4
            found += 1
    assert found >= 3


def test_forced_bits_must_be_binary():
    """Non-0/1 forced bits reach sign = 1-2*bit and NaN the record — every
    semiclassical entry point must reject them up front."""
    import pytest

    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    with pytest.raises(ValueError, match="must be 0/1"):
        run_semiclassical(15, 7, 4, 4, jax.random.PRNGKey(0), forced_bits=[1, 0, 2, 0])
    from quantumcomputer.algorithms.qpe import run_semiclassical_qpe
    from quantumcomputer.models.circuit import PHASE

    with pytest.raises(ValueError, match="must be 0/1"):
        run_semiclassical_qpe(
            lambda j: [PHASE(0, 0.1)], 3, 1, jax.random.PRNGKey(0), forced_bits=[0, -1, 1]
        )


def test_checkpoint_every_validated(tmp_path):
    import pytest

    from quantumcomputer.algorithms.semiclassical import run_semiclassical

    with pytest.raises(ValueError, match="checkpoint_every"):
        run_semiclassical(
            15, 7, 4, 4, jax.random.PRNGKey(0),
            checkpoint_dir=str(tmp_path), checkpoint_every=0,
        )


def test_predictor_matches_engine():
    """The classical eigenphase-mixture predictor
    (scripts/predict_semiclassical.py) reproduces the engine's exact bit
    sequence when replaying its PRNG stream — the independent theory
    oracle used to pick seeds for hardware demo runs."""
    import importlib.util
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "predict_semiclassical.py"
    )
    spec = importlib.util.spec_from_file_location("predict_semiclassical", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    C, a, L, M = 15311, 2, 16, 14  # 251 * 61
    r = mod.multiplicative_order(a, C)
    assert pow(a, r, C) == 1
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        _, sub = jax.random.split(key)
        rec = run_semiclassical(C, a, L, M, sub, jnp.complex64)
        bits, margin = mod.predict_bits(C, a, L, mod.engine_draws(seed, L), r)
        assert rec.bits == bits, (seed, rec.bits, bits)
        assert margin > 0
