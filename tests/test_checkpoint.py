"""Checkpoint/resume: segment snapshots, fingerprint guard, sharded resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer.sim import checkpoint as ckpt
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine


def test_save_load_roundtrip(tmp_path):
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    state = eng.run(shor_circuit(15, 7, 3, 4))
    p = str(tmp_path / "snap.npz")
    ckpt.save_state(p, state, {"k": 1})
    loaded, meta = ckpt.load_state(p)
    assert meta == {"k": 1}
    np.testing.assert_allclose(np.asarray(loaded), np.asarray(state), atol=0)


def test_run_with_checkpoints_matches_direct(tmp_path):
    C, a, L, M = 21, 2, 4, 5
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    direct = eng.to_numpy(eng.run(circ))
    seg = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=3))
    np.testing.assert_allclose(seg, direct, atol=1e-13)
    # snapshots exist for each segment
    assert ckpt.latest_segment(str(tmp_path)) == -(-len(circ) // 3)


def test_resume_from_partial(tmp_path):
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    # Full run writes all segments; drop the last two snapshots to simulate
    # preemption, then resume.
    ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2)
    total = ckpt.latest_segment(str(tmp_path))
    for s in (total, total - 1):
        os.remove(str(tmp_path / f"segment_{s:05d}.npz"))
    resumed = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(resumed, want, atol=1e-12)


def test_fingerprint_guard(tmp_path):
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    circ1 = shor_circuit(15, 7, 3, 4)
    circ2 = shor_circuit(15, 13, 3, 4)
    ckpt.run_with_checkpoints(eng, circ1, str(tmp_path), segment_gates=2)
    # Resuming a DIFFERENT circuit must ignore the stale snapshots.
    out = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ2, str(tmp_path), segment_gates=2))
    want = ref.shor_circuit(15, 13, 3, 4)
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_segment_gates_mismatch_ignored(tmp_path):
    """A snapshot taken under a different segment_gates maps segment index
    to a different gate offset — resume must refuse it, not misapply it."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2)
    # Drop the tail so resume would engage, then resume with a DIFFERENT
    # segmentation: the stale snapshots must be ignored (recompute from 0).
    total = ckpt.latest_segment(str(tmp_path))
    os.remove(str(tmp_path / f"segment_{total:05d}.npz"))
    out = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=3))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_resume_when_all_segments_done(tmp_path):
    """last == len(segments): the final snapshot is loaded and returned
    without recomputing anything."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2)
    calls = []
    orig_run = eng.run
    eng.run = lambda *a, **k: (calls.append(1), orig_run(*a, **k))[1]
    out = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2))
    assert calls == [], "fully-checkpointed run must not re-execute segments"
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(out, want, atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_checkpoint_roundtrip(tmp_path):
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, mesh=build_mesh(num_devices=8))
    out = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=4))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_checkpoint_roundtrip_complex32(tmp_path):
    """bf16 planar snapshots save/load exactly (np.savez handles ml_dtypes
    bfloat16) and resume through run_with_checkpoints at complex32."""
    C, a, L, M = 33, 29, 8, 6
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

    circ = shor_circuit_mhigh(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype="complex32", layout="m_high")
    direct = eng.run(circ)
    p = str(tmp_path / "c32.npz")
    ckpt.save_state(p, direct, {"dtype": "complex32"})
    loaded, meta = ckpt.load_state(p)
    assert loaded.dtype == jnp.bfloat16 and meta["dtype"] == "complex32"
    np.testing.assert_array_equal(
        np.asarray(loaded.astype(jnp.float32)), np.asarray(direct.astype(jnp.float32))
    )
    out = ckpt.run_with_checkpoints(eng, circ, str(tmp_path / "segs"), segment_gates=7)
    np.testing.assert_allclose(
        np.asarray(out.astype(jnp.float32)),
        np.asarray(direct.astype(jnp.float32)),
        atol=2e-3,
    )


class _Die(RuntimeError):
    pass


def test_find_period_kill_and_resume(tmp_path, monkeypatch):
    """Driver-level preemption recovery (VERDICT r2 item 8): a process
    killed mid-circuit resumes from the last segment on re-invocation —
    byte-identical final result, no segment re-executed, and the
    measurement never replayed from a snapshot."""
    import quantumcomputer.algorithms.shor as shor_mod

    C, a, L, M = 21, 2, 4, 5
    ckdir = str(tmp_path / "ck")
    seed = jax.random.PRNGKey(3)

    # Uninterrupted reference run (fresh engine, same key).
    e_ref = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    ref_rec = shor_mod.find_period(e_ref, C, a, seed, checkpoint_dir=str(tmp_path / "ref"),
                                   checkpoint_segment_gates=3)

    # "Preempted" run: die after 2 segments have been snapshotted.
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    orig_run = eng.run
    calls = {"n": 0}

    def dying_run(circuit, state=None):
        if calls["n"] >= 2:
            raise _Die("simulated preemption")
        calls["n"] += 1
        return orig_run(circuit, state)

    monkeypatch.setattr(eng, "run", dying_run)
    with pytest.raises(_Die):
        shor_mod.find_period(eng, C, a, seed, checkpoint_dir=ckdir,
                             checkpoint_segment_gates=3)
    assert ckpt.latest_segment(os.path.join(ckdir, f"C{C}_a{a}")) == 2

    # Resume in a "new process": fresh engine, same checkpoint dir.  Count
    # the segments actually executed — the first two must NOT re-run.
    eng2 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    orig_run2 = eng2.run
    executed = []

    def counting_run(circuit, state=None):
        executed.append(len(circuit))
        return orig_run2(circuit, state)

    monkeypatch.setattr(eng2, "run", counting_run)
    rec = shor_mod.find_period(eng2, C, a, seed, checkpoint_dir=ckdir,
                               checkpoint_segment_gates=3)

    circ = shor_circuit(C, a, L, M)
    total_segments = (len(circ) + 2) // 3
    assert len(executed) == total_segments - 2  # resumed, not recomputed
    assert rec.measured_index == ref_rec.measured_index  # same key, same state
    assert rec.period == ref_rec.period == 6
    # attempt directory cleaned up after success
    assert not os.path.isdir(os.path.join(ckdir, f"C{C}_a{a}"))


def test_find_period_checkpoint_state_matches_plain(tmp_path):
    """The segmented checkpoint path produces the same measured index as
    the single-program path for the same key (identical pre-measurement
    state at complex128)."""
    from quantumcomputer.algorithms.shor import find_period

    C, a, L, M = 15, 7, 3, 4
    k = jax.random.PRNGKey(9)
    e1 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    e2 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    r_plain = find_period(e1, C, a, k)
    r_ck = find_period(e2, C, a, k, checkpoint_dir=str(tmp_path / "ck2"))
    assert r_plain.measured_index == r_ck.measured_index
    assert r_plain.period == r_ck.period


def test_cli_checkpoint_dir_flag(tmp_path, capsys):
    from quantumcomputer.cli import main

    rc = main(
        ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0",
         "--dtype", "complex128", "--checkpoint-dir", str(tmp_path / "ckcli")]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Factors of 15 found: (5, 3)." in out


def test_checkpoint_dd64_four_planes_roundtrip(tmp_path):
    """dd64 snapshots must carry all FOUR planes; resuming a dd run from a
    checkpoint yields the same state as an uninterrupted run (reviewer r3:
    the 2-plane save corrupted dd resumes)."""
    from quantumcomputer.sim.dd_engine import DDStateVectorEngine

    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = DDStateVectorEngine(Register(L=L, M=M))
    direct = eng.to_numpy(eng.run(circ, eng.initial_state()))
    eng2 = DDStateVectorEngine(Register(L=L, M=M))
    st = ckpt.run_with_checkpoints(eng2, circ, str(tmp_path / "dd"), segment_gates=3)
    assert np.asarray(st).shape[0] == 4
    np.testing.assert_allclose(eng2.to_numpy(st), direct, atol=1e-14)
    # resume mid-way in a fresh engine: byte-identical
    for f in sorted((tmp_path / "dd").iterdir())[2:]:
        f.unlink()  # "die" after 2 segments
    eng3 = DDStateVectorEngine(Register(L=L, M=M))
    st3 = ckpt.run_with_checkpoints(eng3, circ, str(tmp_path / "dd"), segment_gates=3)
    np.testing.assert_allclose(eng3.to_numpy(st3), direct, atol=1e-14)


def test_checkpoint_plane_count_guard(tmp_path):
    """A 2-plane snapshot fed to a dd64 resume must cold-start, never
    resume corrupt."""
    from quantumcomputer.sim.dd_engine import DDStateVectorEngine

    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    e_c = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    ckpt.run_with_checkpoints(e_c, circ, str(tmp_path / "mix"), segment_gates=3)
    e_dd = DDStateVectorEngine(Register(L=L, M=M))
    st = ckpt.run_with_checkpoints(e_dd, circ, str(tmp_path / "mix"), segment_gates=3)
    # cold restart in dd: result is the dd-accurate state, 4 planes
    assert np.asarray(st).shape[0] == 4
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(e_dd.to_numpy(st), want, atol=1e-12)


def test_checkpoint_wins_over_very_verbose(tmp_path, monkeypatch):
    """-V with checkpoint_dir must still snapshot (reviewer r3: the -V
    branch silently skipped run_with_checkpoints)."""
    from quantumcomputer.algorithms.shor import find_period
    from quantumcomputer.utils import logging as qlog

    monkeypatch.setattr(qlog, "_verbose", True)
    monkeypatch.setattr(qlog, "_very_verbose", True)
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    ckdir = str(tmp_path / "vck")
    rec = find_period(eng, 15, 7, jax.random.PRNGKey(0), checkpoint_dir=ckdir,
                      checkpoint_segment_gates=3)
    assert rec.period == 4
    # attempt dir is cleaned up on success, so assert via the parent having
    # existed + a second interrupted-style call writing snapshots:
    import quantumcomputer.sim.checkpoint as ck_mod

    wrote = []
    orig = ck_mod.save_state
    monkeypatch.setattr(ck_mod, "save_state", lambda *a, **k: wrote.append(a[0]) or orig(*a, **k))
    find_period(eng, 15, 7, jax.random.PRNGKey(1), checkpoint_dir=ckdir,
                checkpoint_segment_gates=3)
    assert wrote, "-V run never wrote a checkpoint snapshot"


def test_resume_skips_stale_higher_segment(tmp_path):
    """A stale HIGHER-numbered snapshot (e.g. from a longer run sharing the
    directory) must not disable resume: the scan walks down to the first
    VALID segment instead of trying only the highest number and
    cold-starting forever."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2)
    total = ckpt.latest_segment(str(tmp_path))
    # Simulate preemption at segment total-2, plus a stale valid-looking
    # snapshot at a higher number from a DIFFERENT circuit.
    for s in (total, total - 1):
        os.remove(str(tmp_path / f"segment_{s:05d}.npz"))
    stale = ckpt._segment_path(str(tmp_path), total + 3)
    ckpt.save_state(
        stale, eng.initial_state(),
        {"fingerprint": "feedfacedeadbeef", "segment": total + 3,
         "segment_gates": 2, "n": L + M},
    )
    resumed = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(resumed, want, atol=1e-12)
    # And a corrupt highest-numbered file must also fall through to the
    # next valid one.
    open(ckpt._segment_path(str(tmp_path), total + 5), "wb").write(b"garbage")
    resumed2 = eng.to_numpy(ckpt.run_with_checkpoints(eng, circ, str(tmp_path), segment_gates=2))
    np.testing.assert_allclose(resumed2, want, atol=1e-12)


def test_fingerprint_distinguishes_matrices():
    """Two u2q circuits differing ONLY in the dense unitary must not share
    a fingerprint (repr omits the matrix; the hash must not)."""
    import numpy as _np

    from quantumcomputer.models.circuit import U2Q

    a = (U2Q(1, 0, _np.eye(4)),)
    b = (U2Q(1, 0, _np.diag([1, 1, 1, -1])),)
    assert ckpt.circuit_fingerprint(a) != ckpt.circuit_fingerprint(b)
    assert ckpt.circuit_fingerprint(a) == ckpt.circuit_fingerprint(a)
