"""Checkpoint/resume: state-vector snapshots between circuit segments.

The reference deliberately recomputes every attempt from the reset register
and never re-measures a collapsed state (qc_shor.c:299-301, 922; Report
§III.E).  That semantic is kept: checkpoints snapshot the *pre-measurement*
evolving state between circuit segments (useful for long sharded runs on
preemptible slices, SURVEY.md §5) — measurement itself is never replayed
from a snapshot by the Shor driver.

Format: .npz with the two planar float planes + a JSON metadata blob
(circuit fingerprint, segment index, register geometry).  Resuming with a
different circuit is refused via the fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import jax
import numpy as np

from quantumcomputer.models.circuit import Circuit
from quantumcomputer.utils.logging import get_logger

log = get_logger("checkpoint")


def circuit_fingerprint(circuit: Circuit) -> str:
    h = hashlib.sha256()
    for g in circuit:
        h.update(repr(g).encode())
        # repr is the compact log form and omits the dense unitary — two
        # u1q/u2q circuits differing only in their matrices must NOT share
        # a fingerprint (a matrix-blind hash let a wrong-circuit resume
        # through the guard).
        if g.matrix is not None:
            h.update(repr(g.matrix).encode())
    return h.hexdigest()[:16]


def save_state(path: str, state: jax.Array, meta: dict) -> None:
    """Snapshot a planar state (host copy) + metadata.

    ALL planes are stored — (2, dim) re/im for the complex engines,
    (4, dim) [re_hi, re_lo, im_hi, im_lo] for dd64 (saving only rows 0-1
    of a dd state silently corrupts the resume; reviewer r3 finding).
    bf16 ("complex32") planes are stored as their uint16 bit patterns with
    a dtype tag — np.savez round-trips ml_dtypes.bfloat16 as an opaque
    void dtype otherwise."""
    planes = np.asarray(state)
    plane_dtype = str(planes.dtype)
    if plane_dtype == "bfloat16":
        planes = planes.view(np.uint16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, planes=planes, meta=json.dumps(meta), plane_dtype=plane_dtype)
    os.replace(tmp, path)


def load_state(path: str, sharding=None) -> Tuple[jax.Array, dict]:
    """Load a snapshot; optionally place it with a NamedSharding."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if "planes" in z:
            planar = z["planes"]
        else:  # round-2 format: separate re/im keys (always 2 planes)
            planar = np.stack([z["re"], z["im"]])
        if "plane_dtype" in z and str(z["plane_dtype"]) == "bfloat16":
            import ml_dtypes

            planar = planar.view(ml_dtypes.bfloat16)
    arr = jax.device_put(planar, sharding) if sharding is not None else jax.device_put(planar)
    return arr, meta


def _segment_path(directory: str, seg: int) -> str:
    return os.path.join(directory, f"segment_{seg:05d}.npz")


def all_segments(directory: str) -> list:
    """Segment numbers present in `directory`, ascending (the one parser of
    the segment_NNNNN.npz naming scheme — keep in lockstep with
    _segment_path)."""
    if not os.path.isdir(directory):
        return []
    segs = []
    for f in os.listdir(directory):
        if f.startswith("segment_") and f.endswith(".npz"):
            try:
                segs.append(int(f[len("segment_"):-len(".npz")]))
            except ValueError:
                pass
    return sorted(segs)


def latest_segment(directory: str) -> Optional[int]:
    segs = all_segments(directory)
    return segs[-1] if segs else None


def run_with_checkpoints(
    engine,
    circuit: Circuit,
    directory: str,
    segment_gates: int = 8,
    resume: bool = True,
    state: Optional[jax.Array] = None,
) -> jax.Array:
    """Run a circuit in segments, snapshotting after each; resume from the
    latest valid snapshot if present.  Works with both the single-chip and
    sharded engines (same planar-state API)."""
    fp = circuit_fingerprint(circuit)
    segments = [circuit[i : i + segment_gates] for i in range(0, len(circuit), segment_gates)]
    start_seg = 0
    if resume:
        # Scan from the NEWEST segment down to the first VALID one (the
        # semiclassical resume's strategy): a single stale higher-numbered
        # snapshot — e.g. left by a longer run that shared the directory —
        # must not permanently disable resume (it used to: only the highest
        # number was tried, so every rerun cold-started and a preemption
        # interval shorter than a full run could livelock the job).
        # seg == len(segments) means every segment (including the final
        # one) is already snapshotted: load it and skip the loop entirely.
        expected_planes = 4 if getattr(engine, "dtype", None) == "dd64" else 2
        for seg in reversed(all_segments(directory)):
            if not (0 < seg <= len(segments)):
                continue
            try:
                sharding = getattr(engine, "sharding", None)
                st, meta = load_state(_segment_path(directory, seg), sharding)
                # segment index alone is ambiguous across segmentations
                # (segment k == "k*segment_gates gates applied"), so a
                # snapshot taken under a different segment_gates would map
                # to the wrong gate offset — refuse it.
                # dd engines carry four planes; complex engines two.  A
                # plane-count mismatch (e.g. an old 2-plane snapshot fed to
                # a dd64 resume) must cold-start, not corrupt.
                if (
                    meta.get("fingerprint") == fp
                    and meta.get("segment") == seg
                    and meta.get("segment_gates") == segment_gates
                    and st.shape[0] == expected_planes
                    # Plane dtype must match the engine: resuming an f32
                    # run's snapshot into a complex32 engine (or vice
                    # versa) would silently continue at the wrong storage
                    # precision.
                    and st.dtype == getattr(engine, "real_dtype", st.dtype)
                ):
                    state = st
                    start_seg = seg
                    break
                log.warning(
                    "checkpoint %s rejected (fingerprint/segmentation/"
                    "dtype mismatch); trying older segments",
                    _segment_path(directory, seg),
                )
            except Exception as e:  # corrupt/unreadable snapshot
                # A silent cold restart is indistinguishable from a resume
                # on a long run — surface the reason (VERDICT r2, weak #7).
                log.warning(
                    "failed to load checkpoint %s (%s: %s); trying older segments",
                    _segment_path(directory, seg), type(e).__name__, e,
                )
    if state is None:
        state = engine.initial_state()
    for seg in range(start_seg, len(segments)):
        state = engine.run(tuple(segments[seg]), state)
        save_state(
            _segment_path(directory, seg + 1),
            state,
            {
                "fingerprint": fp,
                "segment": seg + 1,
                "segment_gates": segment_gates,
                "n": engine.register.n,
            },
        )
    return state
