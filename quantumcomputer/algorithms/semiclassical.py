"""Semiclassical (one-control-qubit) period finding: n = M + 1 qubits.

The reference needs L + M qubits because it holds the whole counting
register in superposition and inverse-QFTs it at the end
(quantum_computation, qc_shor.c:712-737).  The Griffiths–Niu semiclassical
inverse QFT (Phys. Rev. Lett. 76, 3228 (1996); used for Shor by
Mosca–Ekert and in every experimental demonstration, e.g. Vandersypen
2001, Monz 2016) replaces the L counting qubits with ONE qubit that is
prepared, used as the oracle control, phase-corrected by the PREVIOUSLY
MEASURED bits, Hadamarded, measured, and reset — L times:

    for j = L-1 .. 0:
        |c> = H|0>
        controlled-(x -> a^(2^j) x mod C) on the work register
        PHASE(c, pi * sum_{j' already measured} m_{j'} / 2^(j'-j))
        H(c);  m_j = measure(c);  reset c
    x_tilde = sum_j m_j << (L-1-j)      (bit-reversed, like read_omega)

This is EXACTLY the reference circuit with every controlled-phase of the
iQFT ladder deferred onto its lower qubit and evaluated classically once
the upper qubit is measured — the joint outcome distribution is identical
(tests/test_semiclassical.py checks every branch probability against the
full-register engine at 1e-6).  What changes is the resource count: the
state is 2^(M+1) amplitudes instead of 2^(M+L) — factoring C=8191 takes a
2^14 state (microseconds per pass) instead of a 2^30-amplitude full
register.  The reference's own measurement/no-remeasure semantics are kept
per bit (inverse-CDF draw, collapse, never re-sampled).

Device realization: ONE jitted program serves every step of every trial
integer — the oracle scalars (C, a_inv), the correction angle, and the
draw are all runtime operands (the compile-once pattern of
shor_circuit_template), so the L-step loop and the a-trial loop never
recompile.  The oracle's gather indices are generated ON DEVICE from the
two scalars (ops/gates.modmul_permute_onchip — int32 shift-add modular
multiply), so per-step host->device traffic is a few scalars even at
M=28 where a permutation table would be a 1 GiB upload.

The control qubit is IMPLICIT.  It enters every step in |0> and is reset
to |0> after the measurement, so the (M+1)-qubit state is never
materialized: the device state is the WORK register alone, planar
(2, 2^M), and one step is the closed form

    |psi> = |0> (w + e^{i theta} U w)/2 + |1> (w - e^{i theta} U w)/2
    p_m = || w + (-1)^m e^{i theta} U w ||^2 / 4
    w'  = (w + (-1)^m e^{i theta} U w) / (2 sqrt(p_m))

(U = the controlled modular multiply's work-register permutation).  This
halves HBM footprint and traffic per step versus carrying the control
axis — one more qubit of modulus on the same chip — and the gather runs
blockwise (index blocks generated on the fly, branch-probability partial
sums folded into the same pass), so the int32 index vector never
materializes at full length: at M=30 a full table is 4 GiB.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from quantumcomputer.algorithms import number_theory as nt
from quantumcomputer.ops import gates as xops
from quantumcomputer.utils.logging import get_logger

log = get_logger("semiclassical")
from quantumcomputer.sim import statevec as sv


# Index blocks of 2^22 rows (16 MB of int32) for the blockwise oracle
# pass: large enough that the shift-add index chain amortizes, small
# enough that the index vector never shows up in the HBM peak.
_GATHER_BLOCK_LOG = 22


def validate_forced_bits(forced_bits, n: int, what: str = "L"):
    """The ONE forced-bits validator (shared by every semiclassical entry
    point): length must equal the step count — the fused fori_loop gathers
    forces[s] where out-of-bounds CLAMPS instead of raising, so a short
    list would silently force the tail steps — and values must be 0/1:
    any other value reaches collapse_from_a1's sign = 1-2*bit, producing a
    non-physical state and NaN branch probabilities with no error."""
    if forced_bits is None:
        return None
    if len(forced_bits) != n:
        raise ValueError(
            f"forced_bits has {len(forced_bits)} entries; expected {what}={n}"
        )
    bits = [int(b) for b in forced_bits]
    if any(b not in (0, 1) for b in bits):
        raise ValueError(f"forced_bits must be 0/1, got {list(forced_bits)!r}")
    return bits


def _compute_dtype(rdtype):
    """All scalar/reduction arithmetic runs in at least f32: bf16 storage
    (complex32) keeps amplitudes compact, but angles (cos/sin of a
    pi*phi with L meaningful bits), draws, and 2^M-term probability sums
    would be meaningless at 8 mantissa bits."""
    return jnp.float32 if jnp.dtype(rdtype) == jnp.bfloat16 else jnp.dtype(rdtype)


def _oracle_pass(w, M: int, rdtype, cdt, C_s, a_inv_s, ct, st):
    """NOTE: the rotate/fold/probability numerics here are duplicated (by
    necessity — they fuse into the blockwise gather) in qpe._blend_fn for
    the generic-U form; keep the cdt upcast points and s2 factors in
    lockstep or the distribution-parity tests diverge.

    Pass 1 of a semiclassical step: a1 = e^{i theta} U (w/sqrt2) with
    the branch-probability partial sums folded into the same sweep.

    U is the work-register permutation of the controlled modular multiply
    (j -> a*j mod C realized as a gather by the inverse map).  The gather
    runs BLOCKWISE: each block's int32 indices are generated on device
    (ops/gates.modmul_permute_onchip) and die with the block, and the
    reduction consumes b0/b1 elementwise without materializing them — the
    program's live set is w, a1, and one index block.

    Returns (a1 planar (2, 2^M) rdtype, p0, p1) with p0/p1 accumulated in
    cdt (f32 sums over bf16 storage are fused upcasts, not extra traffic).
    """
    s2 = jnp.asarray(1.0 / math.sqrt(2.0), rdtype)
    dim = 1 << M

    def block(j0, blk: int):
        idx = xops.modmul_permute_onchip(
            a_inv_s, jnp.asarray(j0, jnp.int32) + lax.iota(jnp.int32, blk), C_s, M
        )
        g = w[:, idx] * s2  # == (w * s2)[:, ginv_block]: scale commutes exactly
        a1 = jnp.stack([ct * g[0] - st * g[1], st * g[0] + ct * g[1]]).astype(rdtype)
        a0 = lax.dynamic_slice_in_dim(w, j0, blk, axis=1) * s2
        b0 = (a0 + a1) * s2
        b1 = (a0 - a1) * s2
        p0 = jnp.sum(b0[0].astype(cdt) ** 2 + b0[1].astype(cdt) ** 2)
        p1 = jnp.sum(b1[0].astype(cdt) ** 2 + b1[1].astype(cdt) ** 2)
        return a1, p0, p1

    if M <= _GATHER_BLOCK_LOG:
        return block(0, dim)

    blk = 1 << _GATHER_BLOCK_LOG

    def body(i, carry):
        a1_full, p0, p1 = carry
        a1_b, p0_b, p1_b = block(i * blk, blk)
        return (
            lax.dynamic_update_slice_in_dim(a1_full, a1_b, i * blk, axis=1),
            p0 + p0_b, p1 + p1_b,
        )

    init = (jnp.zeros_like(w), jnp.zeros((), cdt), jnp.zeros((), cdt))
    return lax.fori_loop(0, dim >> _GATHER_BLOCK_LOG, body, init)


def _oracle_pass_structured(w, M: int, rdtype, cdt, plan, ct, st):
    """_oracle_pass with the gather replaced by the structured
    modular-stride permutation (ops/modperm), which moves whole rows and
    slices instead of single elements (the two are timed against each
    other in PERF.md).

    Requires static (C, a_inv) — the caller compiles per step value
    instead of tracing the scalars.  The permutation runs ONE PLANE AT A
    TIME: its transient buffers (cyclic extensions, transpose pads) then
    scale with half a state, which is what keeps the peak inside the
    per-step budget at the memory ceiling."""
    from quantumcomputer.ops.modperm import apply_stride_permute

    s2 = jnp.asarray(1.0 / math.sqrt(2.0), rdtype)
    gr = apply_stride_permute(w[0:1], plan)[0] * s2
    # Explicitly sequence the imaginary-plane permutation AFTER the real
    # one: the two are data-independent, and without the barrier XLA
    # schedules them concurrently — two full sets of leg transients live
    # at once, which is the difference between fitting and OOM at the
    # memory ceiling (M=28 f32 measured 18.0 GB vs a 15.75 GB chip).
    wi, gr = lax.optimization_barrier((w[1:2], gr))
    gi = apply_stride_permute(wi, plan)[0] * s2
    a1 = jnp.stack([ct * gr - st * gi, st * gr + ct * gi]).astype(rdtype)
    a0 = w * s2
    b0 = (a0 + a1) * s2
    b1 = (a0 - a1) * s2
    p0 = jnp.sum(b0[0].astype(cdt) ** 2 + b0[1].astype(cdt) ** 2)
    p1 = jnp.sum(b1[0].astype(cdt) ** 2 + b1[1].astype(cdt) ** 2)
    return a1, p0, p1


def _step_core(w, M: int, rdtype, C_s, a_inv_s, theta, r, force):
    """One semiclassical step on the WORK register only (the control
    qubit is implicit — module docstring): H on the control, controlled
    modular multiply, deferred-phase rotation, H, measure-collapse-reset,
    algebraically closed over w.

    Pure PLANAR arithmetic throughout — no complex materialization.  Two
    sweeps of w: the oracle/reduction pass (_oracle_pass) and the
    collapse pass out = (w + (-1)^m e^{i theta} U w) / (2 sqrt(p_m)),
    which reads w and a1 and writes the collapsed, renormalized, reset
    state directly (peak matters: at M=30/bf16 the state is 4.3 GB).

    Returns (bit int32, conditional branch probability in cdt, new w)."""
    cdt = _compute_dtype(rdtype)
    theta = jnp.asarray(theta, cdt)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    a1, p0, p1 = _oracle_pass(w, M, rdtype, cdt, C_s, a_inv_s, ct, st)
    return collapse_from_a1(w, a1, p0, p1, r, force, rdtype, cdt)


def collapse_from_a1(w, a1, p0, p1, r, force, rdtype, cdt):
    """Measure-collapse-reset of the implicit control qubit given the
    rotated branch a1 = e^{i theta} U (w/sqrt2) and the two branch weights
    (module docstring closed form).  Shared by the Shor oracle step above
    and the generic semiclassical QPE (algorithms/qpe.py), whose U is an
    arbitrary circuit rather than the modular-multiply gather."""
    s2 = jnp.asarray(1.0 / math.sqrt(2.0), rdtype)
    total = p0 + p1  # 1 up to roundoff; strict states may differ
    bit = (jnp.asarray(r, cdt) * total >= p0).astype(jnp.int32)
    # force >= 0 walks that branch regardless of the draw (the exact
    # distribution-parity test hook; dead branches yield p_branch ~ 0 and
    # a meaningless collapsed state, by design).
    bit = jnp.where(force >= 0, force, bit)
    p_branch = jnp.where(bit == 1, p1, p0)
    # (-1)^bit as an exact sign: a0 + sign*a1 is bitwise a0 +/- a1.
    sign = (1 - 2 * bit).astype(rdtype)
    out = (w * s2 + sign * a1) * s2 / jnp.sqrt(p_branch).astype(rdtype)
    return bit, p_branch / total, out


def _attempt_fn(L: int, M: int, rdtype) -> Callable:
    """A WHOLE semiclassical attempt — all L measure-and-reset steps — as
    ONE compiled program (lax.fori_loop), so an attempt is a single device
    dispatch regardless of L.  The deferred-phase bookkeeping runs on
    device via the standard semiclassical recurrence: with steps indexed
    s = 0..L-1 (exponent j = L-1-s),

        theta_s = pi * sum_{s'<s} m_{s'} / 2^(s-s') = pi * phi_s,
        phi_{s+1} = (phi_s + m_s) / 2,   phi_0 = 0

    — one scalar carried between iterations replaces the host round-trip
    per measured bit: the whole attempt is one dispatch.

    (w planar (2, 2^M), C scalar, a_inv (L,), r (L,), force (L,)) ->
    (bits (L,) int32, conditional branch probs (L,), final w).

    The control qubit is implicit (module docstring); the state carried
    between iterations is the work register alone.  Each conditional
    probability is the exact branch weight — the distribution-parity
    tests multiply them back into joint weights."""
    cdt = _compute_dtype(rdtype)

    def body(s, carry):
        w, phi, bits, probs, C_s, a_inv_arr, rs, forces = carry
        theta = (jnp.pi * phi).astype(cdt)
        bit, p_cond, out = _step_core(
            w, M, rdtype, C_s, a_inv_arr[s], theta, rs[s], forces[s]
        )
        phi = (phi + bit.astype(cdt)) / 2
        return (
            out, phi, bits.at[s].set(bit), probs.at[s].set(p_cond.astype(cdt)),
            C_s, a_inv_arr, rs, forces,
        )

    def attempt(w, C_s, a_inv_arr, rs, forces):
        carry = (
            w, jnp.zeros((), cdt),
            jnp.zeros((L,), jnp.int32), jnp.zeros((L,), cdt),
            C_s, a_inv_arr, rs, forces,
        )
        w, _, bits, probs, *_ = jax.lax.fori_loop(0, L, body, carry)
        return bits, probs, w

    return jax.jit(attempt, donate_argnums=(0,))


def _structured_plans(C: int, a_invs, M: int, rdtype=jnp.float32):
    """Per-step stride-permutation plans for a semiclassical attempt.
    The deal leg's pad transients (2*W*u elements, live in both the
    concatenated view and its transpose) must fit the device memory left
    over after the step envelope, so W is capped from the device budget;
    off the memory ceiling that cap stays at the plan maximum.  Entries are
    None where the structured path does not apply (tiny or identity
    multipliers, or a transient that would not fit next to the state) —
    the attempt falls back to the static-scalar gather there."""
    from quantumcomputer.ops import modperm
    from quantumcomputer.utils.memory import device_hbm_budget

    itemsize = jnp.dtype(rdtype).itemsize
    plane_bytes = (1 << M) * itemsize
    # W-independent peak: the 3-state step envelope plus the legs'
    # plane-proportional transients (cyclic extension + transpose copy,
    # ~2 planes live at once inside a leg).
    fixed = _STEP_STATES_HEADROOM * 2 * plane_bytes + 2 * plane_bytes
    allowed_Wu = max(0, device_hbm_budget() - fixed) // (4 * itemsize)
    plans = []
    for ai in a_invs:
        plan = modperm.plan_stride_permute(C, int(ai), M)
        if plan is not None and plan.u > 1 and plan.W * plan.u > allowed_Wu:
            cap = plan.W
            while cap > modperm._MIN_CHUNK and cap * plan.u > allowed_Wu:
                cap //= 2
            plan = (
                modperm.plan_stride_permute(C, int(ai), M, max_chunk=cap)
                if cap * plan.u <= allowed_Wu
                else None
            )
        plans.append(plan)
    return plans


def _unrolled_steps(w, phi, rs, forces, plans, a_invs, M, rdtype, cdt, C_s):
    """The traced body shared by the whole-attempt and segment forms of
    the structured attempt: len(plans) unrolled steps with static per-step
    oracles (stride permutation where a plan exists, static-scalar gather
    fallback elsewhere).  Returns (bits, probs, w, phi)."""
    bits, probs = [], []
    for i in range(len(plans)):
        if i:
            # Pin step boundaries: without the barrier XLA's scheduler
            # overlaps the unrolled steps' oracle fusions (measured:
            # every step's rotate temp live at once — one extra
            # state-sized buffer per step, OOM at M=28).
            w, phi = lax.optimization_barrier((w, phi))
        theta = (jnp.pi * phi).astype(cdt)
        ct, st = jnp.cos(theta), jnp.sin(theta)
        if plans[i] is not None:
            a1, p0, p1 = _oracle_pass_structured(
                w, M, rdtype, cdt, plans[i], ct, st
            )
        else:
            a1, p0, p1 = _oracle_pass(
                w, M, rdtype, cdt, C_s,
                jnp.asarray(a_invs[i], jnp.int32), ct, st,
            )
        bit, p_cond, w = collapse_from_a1(
            w, a1, p0, p1, rs[i], forces[i], rdtype, cdt
        )
        phi = (phi + bit.astype(cdt)) / 2
        bits.append(bit)
        probs.append(p_cond.astype(cdt))
    return jnp.stack(bits), jnp.stack(probs), w, phi


def _attempt_fn_structured(L: int, M: int, rdtype, C: int, a: int) -> Callable:
    """A whole semiclassical attempt with STATIC per-step oracles: the L
    steps are unrolled (not a fori_loop), so each step's modular multiply
    can use the structured stride permutation (ops/modperm) — static
    (C, a_inv) per step — instead of the runtime-scalar element gather.

    Compiled per (C, a, L, M, dtype) — one program, unlike a
    per-step-program form which would pay the compile latency L times.
    The initial |0..01> state is BUILT INSIDE the program and the final
    state is not returned, so the program has no state-sized operands.

    (rs (L,), forces (L,)) -> (bits (L,) int32, conditional probs (L,)).
    """
    cdt = _compute_dtype(rdtype)
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)]
    plans = _structured_plans(C, a_invs, M, rdtype)
    C_s = jnp.asarray(C, jnp.int32)

    def attempt(rs, forces):
        w = sv.initial_planar(M, rdtype, 1)
        phi = jnp.zeros((), cdt)
        bits, probs, _, _ = _unrolled_steps(
            w, phi, rs, forces, plans, a_invs, M, rdtype, cdt, C_s
        )
        return bits, probs

    return jax.jit(attempt)


def _attempt_fn_structured_segment(
    L: int, M: int, rdtype, C: int, a: int, s0: int, s1: int
) -> Callable:
    """Steps [s0, s1) of a structured attempt as one compiled program —
    the CHECKPOINTABLE form of _attempt_fn_structured: the attempt runs
    as ceil(L / checkpoint_every) segment dispatches with the state and
    the deferred phase carried between them as device arrays, and the
    caller snapshots (state, bits, probs) at every segment boundary.
    Same per-step oracles (stride permutation plans, gather fallback) as
    the whole-attempt program; the segment boundary costs one dispatch
    and makes the state an OPERAND — in + out stay live across the
    dispatch (see _STEP_STATES_HEADROOM), so the segmented form can need
    up to one extra live state vs the operand-free whole-attempt program;
    a structured run past the fused 4-state envelope logs a warning
    (run_semiclassical).

    (w (2, 2^M), phi cdt, rs (s1-s0,), forces (s1-s0,)) ->
    (bits, probs, w', phi')."""
    cdt = _compute_dtype(rdtype)
    a_invs = [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(s0, s1)]
    plans = _structured_plans(C, a_invs, M, rdtype)
    C_s = jnp.asarray(C, jnp.int32)

    def segment(w, phi, rs, forces):
        return _unrolled_steps(
            w, phi, rs, forces, plans, a_invs, M, rdtype, cdt, C_s
        )

    return jax.jit(segment, donate_argnums=(0,))


def _step_fn(M: int, rdtype) -> Callable:
    """One semiclassical step as its own compiled program.  This is the
    MEMORY-CEILING form: a fori_loop program's carries double-buffer, so
    at the largest M the fused attempt exceeds device memory where the
    step program still fits — L dispatches buy back the last qubit.

    The deferred phase phi is a DEVICE scalar carried between dispatches
    (same recurrence as the fused form), so the host never needs a step's
    measured bit to build the next dispatch: all L steps are enqueued
    asynchronously and the host blocks only on the final readout (or a
    checkpoint snapshot).

    (w (2, 2^M), phi cdt scalar, C, a_inv, r, force) ->
    (bit, p_cond, w', phi')."""
    cdt = _compute_dtype(rdtype)

    def step(w, phi, C_s, a_inv_s, r, force):
        theta = (jnp.pi * phi).astype(cdt)
        bit, p_cond, out = _step_core(w, M, rdtype, C_s, a_inv_s, theta, r, force)
        return bit, p_cond, out, (phi + bit.astype(cdt)) / 2

    return jax.jit(step, donate_argnums=(0,))


# Device-memory budgets in units of one (2, 2^M) WORK-register state (the control
# qubit is implicit and the index blocks are 16 MB — neither shows up).
# Fused: the fori_loop carry double-buffers (2x) while the gathered a1
# and loop temporaries live (~2x).
_FUSED_STATES_HEADROOM = 4

# Per-step: in + out live across the dispatch boundary plus the gathered
# a1 (~1x).
_STEP_STATES_HEADROOM = 3

def fused_attempt_fits(M: int, rdtype) -> bool:
    from quantumcomputer.utils.memory import device_hbm_budget

    state_bytes = 2 * (1 << M) * jnp.dtype(rdtype).itemsize
    return _FUSED_STATES_HEADROOM * state_bytes <= device_hbm_budget()


def step_program_fits(M: int, rdtype) -> bool:
    from quantumcomputer.utils.memory import device_hbm_budget

    state_bytes = 2 * (1 << M) * jnp.dtype(rdtype).itemsize
    return _STEP_STATES_HEADROOM * state_bytes <= device_hbm_budget()


class SemiclassicalRecord:
    """Outcome of one semiclassical period-finding attempt."""

    def __init__(self, bits: List[int], branch_probs: List[float], x_tilde: int, omega: float):
        self.bits = bits                  # m_{L-1} .. m_0 in measurement order
        self.branch_probs = branch_probs  # conditional probability per bit
        self.x_tilde = x_tilde
        self.omega = omega

    @property
    def probability(self) -> float:
        """Joint probability of this branch (product of conditionals)."""
        p = 1.0
        for b in self.branch_probs:
            p *= float(b)
        return p

    @classmethod
    def from_bits(cls, bits: List[int], branch_probs: List[float]) -> "SemiclassicalRecord":
        """Assemble a record from the measurement-order bits: the readout is
        bit-REVERSED (read_omega convention, qc_shor.c:868-883) — the
        first-measured bit (exponent L-1, physical N-1) is the LSB of x~.
        The single home of that convention for every semiclassical engine
        (full-precision, dd64, sharded)."""
        x_tilde = 0
        for pos, m in enumerate(bits):
            x_tilde |= m << pos
        omega = x_tilde / float(1 << len(bits))
        return cls(bits, branch_probs, x_tilde, omega)


def _attempt_fingerprint(C, a, L, M, rdtype, key, forces) -> str:
    """Identity of one semiclassical attempt for checkpoint matching: the
    draws derive deterministically from the key, so (args, key, forces)
    pin the whole measurement record."""
    h = hashlib.sha256()
    # "-work": the implicit-control layout — snapshots of the older
    # (2, 2^(M+1)) explicit-control shape must never match.
    h.update(f"semiclassical-work|{C}|{a}|{L}|{M}|{jnp.dtype(rdtype).name}".encode())
    # Typed PRNG keys (jax.random.key) refuse np.asarray — hash the raw
    # key data; legacy uint32 keys pass through key_data-equivalent.
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    h.update(np.asarray(key).tobytes())
    h.update(np.asarray(forces, np.int32).tobytes())
    return h.hexdigest()[:16]


def _scan_resume(attempt_dir: str, fp: str, L: int):
    """Find the newest snapshot in attempt_dir matching this attempt's
    fingerprint: (state_or_None, bits, probs, start_step).  Shared by the
    per-step and segmented-structured checkpoint paths — their snapshots
    are interchangeable (same planar state + measurement record), so an
    attempt can resume across a path switch."""
    from quantumcomputer.sim import checkpoint as ckpt

    segs = ckpt.all_segments(attempt_dir)
    for seg in reversed(segs):
        if seg >= L:
            continue
        try:
            loaded, meta = ckpt.load_state(ckpt._segment_path(attempt_dir, seg))
        except Exception as e:
            log.warning("semiclassical snapshot %d unreadable (%s): skipped", seg, e)
            continue
        if meta.get("fingerprint") == fp and meta.get("step") == seg:
            log.info("resuming semiclassical attempt at step %d/%d", seg, L)
            return (
                loaded,
                [int(b) for b in meta["bits"]],
                [float(p) for p in meta["probs"]],
                seg,
            )
    if segs:
        log.info("no snapshot matches this attempt: cold start")
    return None, [], [], 0


def _phi_from_bits(bits, cdt):
    """Replay the deferred-phase recurrence phi' = (phi + m)/2 for already
    measured bits in cdt — bit-identical to the scalar the device would
    carry, so a resumed attempt's angles match an uninterrupted run's."""
    t = np.dtype(cdt).type
    ph = t(0)
    for m in bits:
        ph = t((ph + t(m)) / t(2))
    return jnp.asarray(ph, cdt)


def run_semiclassical(
    C: int,
    a: int,
    L: int,
    M: int,
    key: jax.Array,
    dtype=jnp.complex64,
    forced_bits: Optional[List[int]] = None,
    fused: Optional[bool] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 4,
    structured: bool = False,
    _cache: dict = {},
) -> SemiclassicalRecord:
    """One semiclassical period-finding attempt: L sequential one-qubit
    measurements on an (M+1)-qubit state.

    forced_bits: walk a specific measurement branch instead of sampling
    (the draws are ignored); branch_probs still record the exact
    conditional probabilities — the distribution-parity test hook.

    fused: None (default) auto-selects — the whole attempt runs as ONE
    compiled fori_loop program when the device memory budget allows
    (fused_attempt_fits), else L per-step dispatches with the deferred
    phase maintained on the host.  Both paths share _step_core.

    structured: False (default) runs the compile-once gather programs,
    which serve every step of every trial integer.  True unrolls the whole
    attempt into one program whose per-step modular multiplies run as
    stride permutations (ops/modperm) instead of element gathers: a faster
    step on the GPU, but one compile per (C, a, L, M, dtype) that costs
    far more than it saves in a single attempt (PERF.md).  Ignored for
    dd64.
    With checkpoint_dir the attempt runs SEGMENTED (one unrolled program
    per checkpoint_every steps, state + deferred phase carried between
    dispatches as device arrays) so headline-class structured runs survive
    preemption too — one compile per segment instead of one per attempt.

    checkpoint_dir: snapshot (state, bits, probs) every checkpoint_every
    steps for preemption recovery — a killed attempt re-invoked with the
    same arguments resumes from the last snapshot with no re-measure (the
    measured bits travel WITH the collapsed state; the reference's
    no-remeasure semantic, qc_shor.c:299-301, is what makes the pair
    inseparable).  On the gather path this forces per-step dispatch (the
    fused attempt is a single dispatch with no step boundary to
    snapshot); the structured path runs segmented instead (one unrolled
    program per checkpoint_every steps).  Each snapshot is
    a host sync (state fetch) in an otherwise fully asynchronous dispatch
    chain — checkpoint_every trades recovery granularity against sync
    latency."""
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary")
    if M > 30:
        raise ValueError(f"M={M} > 30 exceeds the int32 index budget")
    if C >= (1 << 30):
        # ops/gates.modmul_onchip keeps intermediates < 2C: int32 needs C < 2^30.
        raise ValueError(f"C={C} >= 2^30 exceeds the int32 shift-add modular-arithmetic bound")
    if L > 52:
        raise ValueError(f"L={L} > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)")
    if math.gcd(a, C) != 1:
        raise ValueError(f"a={a} not coprime to C={C}: gate is not a permutation")
    forced_bits = validate_forced_bits(forced_bits, L, "L")
    if checkpoint_dir is not None and checkpoint_every <= 0:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be positive")
    if isinstance(dtype, str) and dtype == "dd64":
        # f64-grade parity mode: host-synchronous per-step driver with its
        # own (4, 2^M) dd-planar state (algorithms/semiclassical_dd.py).
        if checkpoint_dir is not None:
            raise ValueError("dd64 semiclassical has no checkpointing (parity mode)")
        # dd bytes/amp == complex128's (four f32 planes): gate the per-step
        # footprint the same way.
        if not step_program_fits(M, jnp.dtype(jnp.float64)):
            raise ValueError(
                f"dd64 semiclassical work state 2^{M} amplitudes (16 B each) "
                "exceeds the device memory budget for per-step programs"
            )
        from quantumcomputer.algorithms.semiclassical_dd import run_semiclassical_dd

        return run_semiclassical_dd(C, a, L, M, key, forced_bits=forced_bits)
    rdtype = sv.real_dtype_of(dtype)
    if checkpoint_dir is not None:
        fused = False  # snapshots need step boundaries (docstring)
    if fused is None:
        if not step_program_fits(M, rdtype):
            from quantumcomputer.utils.memory import device_hbm_budget

            raise ValueError(
                f"semiclassical work state 2^{M} amplitudes exceeds the device "
                f"memory budget ({device_hbm_budget() >> 30} GiB) even for "
                "per-step programs (--devices N or dtype='complex32' raise "
                "the ceiling)"
            )
        fused = fused_attempt_fits(M, rdtype)

    # Step s applies the controlled a^(2^(L-1-s)) mod C multiply; the
    # modular inverses are L Python bigint pows — the ONLY host work.
    a_invs = np.asarray(
        [pow(pow(a, 1 << (L - 1 - s), C), -1, C) for s in range(L)], np.int32
    )
    cdt = _compute_dtype(rdtype)
    rs = jax.random.uniform(key, (L,), dtype=cdt)
    forces = np.full((L,), -1, np.int32)
    if forced_bits is not None:
        forces = np.asarray(forced_bits, np.int32)
    C_s = jnp.asarray(C, jnp.int32)

    if structured and checkpoint_dir is not None:
        # SEGMENTED structured attempt: one unrolled program per
        # checkpoint_every steps, the state and deferred phase carried
        # between dispatches as device arrays, a snapshot at every
        # segment boundary.  Segment starts realign to checkpoint_every
        # multiples so a resumed attempt reuses the same compiled
        # segments an uninterrupted run would.
        import os
        import shutil

        from quantumcomputer.sim import checkpoint as ckpt

        if not fused_attempt_fits(M, rdtype):
            # A structured run past the fused 4-state envelope: the
            # segment program carries the state as an operand (in + out
            # live across the dispatch — up to one extra live state
            # vs the operand-free whole-attempt program), so this
            # configuration may exceed the device memory budget.
            log.warning(
                "structured segmented attempt forced at M=%d past the fused "
                "memory envelope: segment programs keep in+out states live "
                "across the dispatch and may OOM; the per-step gather path "
                "owns this regime (drop structured=True)", M,
            )
        fp = _attempt_fingerprint(C, a, L, M, rdtype, key, forces)
        attempt_dir = os.path.join(checkpoint_dir, f"sc_{fp}")
        loaded, bits, probs, start_s = _scan_resume(attempt_dir, fp, L)
        w = loaded if loaded is not None else sv.initial_planar(M, rdtype, 1)
        phi_d = _phi_from_bits(bits, cdt)
        s = start_s
        # Segment-program cache: LRU (a hit reinserts at the end) with the
        # bound sized to the attempt, so an attempt spanning more than the
        # default never evicts its OWN earlier segments and a resumed
        # attempt reuses the programs an uninterrupted run had cached.
        seg_cap = max(32, -(-L // checkpoint_every))
        while s < L:
            s_end = min(L, (s // checkpoint_every + 1) * checkpoint_every)
            ck = ("structured-seg", C, a, L, M, jnp.dtype(rdtype).name, s, s_end)
            seg_fn = _cache.pop(ck, None)
            if seg_fn is None:
                seg_fn = _attempt_fn_structured_segment(L, M, rdtype, C, a, s, s_end)
                skeys = [k for k in _cache
                         if isinstance(k, tuple) and k[0] == "structured-seg"]
                while len(skeys) >= seg_cap:
                    del _cache[skeys.pop(0)]
            _cache[ck] = seg_fn  # (re)insert last: dict order is LRU order
            bits_d, probs_d, w, phi_d = seg_fn(
                w, phi_d, rs[s:s_end], jnp.asarray(forces[s:s_end])
            )
            bits += [int(b) for b in np.asarray(bits_d)]
            probs += [float(p) for p in np.asarray(probs_d)]
            if s_end < L:
                ckpt.save_state(
                    ckpt._segment_path(attempt_dir, s_end), w,
                    {"kind": "semiclassical", "fingerprint": fp, "step": s_end,
                     "bits": bits, "probs": probs},
                )
            s = s_end
        shutil.rmtree(attempt_dir, ignore_errors=True)  # attempt complete
        return SemiclassicalRecord.from_bits(bits, probs)

    if structured:
        # One unrolled program per (C, a, L, M, dtype): per-step static
        # stride-permutation oracles (_attempt_fn_structured).  Programs
        # are large (L unrolled steps), so the cache is LRU-bounded — a
        # trial loop compiles one program per trial integer.
        ck = ("structured", C, a, L, M, jnp.dtype(rdtype).name)
        attempt = _cache.get(ck)
        if attempt is None:
            attempt = _attempt_fn_structured(L, M, rdtype, C, a)
            skeys = [k for k in _cache if isinstance(k, tuple) and k[0] == "structured"]
            if len(skeys) >= 8:
                del _cache[skeys[0]]
            _cache[ck] = attempt
        bits_d, probs_d = attempt(rs, jnp.asarray(forces))
        bits = [int(b) for b in np.asarray(bits_d)]
        probs = [float(p) for p in np.asarray(probs_d)]
        return SemiclassicalRecord.from_bits(bits, probs)

    # |1>: the work register alone (the control is implicit, always |0>
    # at step boundaries — reset_register semantics, qc_shor.c:318-324).
    planar = sv.initial_planar(M, rdtype, 1)
    if fused:
        ck = (L, M, jnp.dtype(rdtype).name)
        attempt = _cache.get(ck)
        if attempt is None:
            attempt = _cache[ck] = _attempt_fn(L, M, rdtype)
        bits_d, probs_d, _ = attempt(
            planar, C_s, jnp.asarray(a_invs), rs, jnp.asarray(forces)
        )
        bits = [int(b) for b in np.asarray(bits_d)]
        probs = [float(p) for p in np.asarray(probs_d)]
    else:
        ck = ("step", M, jnp.dtype(rdtype).name)
        step = _cache.get(ck)
        if step is None:
            step = _cache[ck] = _step_fn(M, rdtype)
        bits, probs = [], []
        start_s = 0
        fp = None
        attempt_dir = None
        if checkpoint_dir is not None:
            import os

            from quantumcomputer.sim import checkpoint as ckpt

            # One subdirectory PER ATTEMPT (keyed by the fingerprint), like
            # find_period's C{C}_a{a} layout: a trial loop's earlier
            # attempts neither shadow this one's segments nor accumulate —
            # each attempt removes its own subdir on completion.
            fp = _attempt_fingerprint(C, a, L, M, rdtype, key, forces)
            attempt_dir = os.path.join(checkpoint_dir, f"sc_{fp}")
            loaded, bits, probs, start_s = _scan_resume(attempt_dir, fp, L)
            if loaded is not None:
                planar = loaded
        # The deferred phase is a DEVICE scalar: replay the resumed bits'
        # recurrence in cdt (bit-identical to what the device would hold),
        # then chain all remaining dispatches WITHOUT host syncs — bits
        # and probabilities are fetched once at the end.  Each snapshot is
        # the only sync in a checkpointed run.
        phi_d = _phi_from_bits(bits, cdt)
        bits_d: List[jax.Array] = []
        probs_d: List[jax.Array] = []
        for s in range(start_s, L):
            bit_d, p_d, planar, phi_d = step(
                planar, phi_d, C_s, jnp.asarray(int(a_invs[s]), jnp.int32),
                rs[s], jnp.asarray(int(forces[s]), jnp.int32),
            )
            bits_d.append(bit_d)
            probs_d.append(p_d)
            if attempt_dir is not None and (s + 1) % checkpoint_every == 0 and s + 1 < L:
                from quantumcomputer.sim import checkpoint as ckpt

                ckpt.save_state(
                    ckpt._segment_path(attempt_dir, s + 1), planar,
                    {"kind": "semiclassical", "fingerprint": fp, "step": s + 1,
                     "bits": bits + [int(b) for b in bits_d],
                     "probs": probs + [float(p) for p in probs_d]},
                )
        bits += [int(b) for b in bits_d]
        probs += [float(p) for p in probs_d]
        if attempt_dir is not None:
            import shutil

            shutil.rmtree(attempt_dir, ignore_errors=True)  # attempt complete

    return SemiclassicalRecord.from_bits(bits, probs)


def find_period_semiclassical(
    C: int,
    a: int,
    L: int,
    M: int,
    key: jax.Array,
    dtype=jnp.complex64,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    structured: bool = False,
) -> Tuple[Optional[int], SemiclassicalRecord]:
    """Semiclassical analog of find_period: omega -> continued fractions ->
    period test (same classical pipeline, qc_shor.c:912-964).

    mesh: shard the work register over a device mesh
    (parallel/sharded_semiclassical.py) — the modulus ceiling grows with
    device count.

    checkpoint_dir: per-step preemption snapshots (single-chip only: the
    sharded attempt is one fused dispatch with no step boundary)."""
    if mesh is not None:
        if checkpoint_dir is not None:
            raise ValueError(
                "checkpoint_dir is single-chip only: the sharded attempt is "
                "one fused dispatch with no step boundary to snapshot"
            )
        if isinstance(dtype, str) and dtype == "dd64":
            raise ValueError("dd64 semiclassical is single-chip (parity mode)")
        from quantumcomputer.parallel.sharded_semiclassical import (
            run_semiclassical_sharded,
        )

        rec = run_semiclassical_sharded(C, a, L, M, key, mesh, dtype)
    else:
        rec = run_semiclassical(
            C, a, L, M, key, dtype,
            checkpoint_dir=checkpoint_dir, structured=structured,
        )
    period = nt.find_period_from_omega(
        rec.omega, a, C, num_fractions, trials_per_denominator
    )
    return period, rec
