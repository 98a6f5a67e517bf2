"""Sharded semiclassical period finding: the Griffiths-Niu one-control
engine distributed over a device mesh.

Single-device semiclassical mode (algorithms/semiclassical.py) holds a
2^M-amplitude work state on one device.  This module shards the WORK
register over the mesh so the state per device shrinks with device
count.  The hard bound becomes the int32
shift-add arithmetic itself: C < 2^30 (ops/gates.modmul_onchip keeps
every intermediate < 2C), i.e. 30-bit moduli — against the reference
architecture's 2^(L+M) full-register state (qc_shor.c:68-73 documents its
own 32-qubit ceiling; a 30-bit modulus there would need L+M ~ 90 qubits).

Layout: the per-device shard is planar (2, ls) = [plane, work-rows],
with the work index w sharded over its LEADING bits (device e owns w in
[e*ls, (e+1)*ls)).  The control qubit is IMPLICIT, exactly as on the
single chip (algorithms/semiclassical.py module docstring): it enters
every step in |0> and is reset there, so one step is the closed form
w' = (w + (-1)^m e^{i theta} U w) / (2 sqrt(p_m)) over the work register
alone — half the per-chip footprint and traffic of carrying a control
axis.  Every semiclassical primitive except the oracle is
communication-free:

  - the two H butterflies and the deferred-phase rotation: elementwise
    combinations of the local w and (exchanged) U w shards;
  - measurement of the control: two local partial sums + one psum;
  - collapse + renormalize + reset: one elementwise output pass.

The ONLY collective is the oracle's modular-multiply permutation
y[w] = x[(b_inv * w) mod C], which scatters globally — a modular rotation
has no block structure, so every device needs rows from every other.  It
runs as ONE all_to_all per step with NO index metadata on the wire:

  - the SENDER bins its local rows by destination device (w = (b * s)
    mod C computed on device, ops/gates.modmul_permute_onchip) and packs
    them in (destination, source-index-ascending) order;
  - the RECEIVER independently reconstructs the arrival order by sorting
    its output rows by (source device, source index) — both sides derive
    the same matching from the same arithmetic, so the exchanged buffers
    carry amplitudes ONLY.

Rows outside the permutation's support (s >= C, the identity region) stay
local and never enter the exchange.

Bin capacity is STATIC but EXACT: the per-destination bin loads of the map
s -> (b*s) mod C over each device's source block are counted on the host
with Euclidean lattice counting (_floor_sum, O(log C) per (sender, dest)
pair — no 2^M array is ever touched), and the buffer capacity is the
maximum over all steps' multipliers, rounded up to a power of two so the
compile cache stays small across trial integers.  This matters because
bin loads are NOT uniform: a smooth multiplier (b = a^(2^j) for small j —
e.g. a = 2 gives b = 2, 4, 16 in the last steps) maps source blocks
nearly linearly and concentrates up to ls/2 rows in one bin, where a
rough multiplier equidistributes (~ls/D per bin, three-distance-theorem
deviations).  An assumed-uniform capacity would silently truncate exactly
those steps; an on-device overflow counter (psum'd, host-checked) defends
the host arithmetic itself.  Steps whose multiplier is 1 (ord(a) divides
the exponent) skip the exchange entirely via lax.cond — their "bin load"
would be the whole shard.

The whole L-step attempt compiles to ONE shard_map'd fori_loop program,
mirroring the single-chip fused form: the reset is folded in (no
state-sized operand crosses the program boundary), the deferred phase
runs the on-device recurrence phi <- (phi + m)/2, draws/forces are
replicated operands, and per-step multipliers (a^(2^j) mod C and inverse)
arrive as (L,) int32 arrays.  Reference semantics preserved bit-for-bit:
measure / collapse / no-remeasure per step (qc_shor.c:689-746),
bit-reversed omega readout (qc_shor.c:868-883).
"""

from __future__ import annotations

import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from quantumcomputer.algorithms.semiclassical import (
    SemiclassicalRecord,
    _compute_dtype,
    validate_forced_bits,
)
from quantumcomputer.ops import gates as xops
from quantumcomputer.parallel.mesh import AXIS, mesh_degree
from quantumcomputer.sim import statevec as sv

# int32 shift-add modular arithmetic bound (ops/gates.modmul_onchip):
# intermediates stay < 2C, so C < 2^30 keeps them inside int32.
MAX_MODULUS_BITS = 30


# -- exact bin-load counting (host, arbitrary-precision ints) ---------------


def _floor_sum(n: int, m: int, a: int, b: int) -> int:
    """sum_{i=0}^{n-1} floor((a*i + b) / m) by the Euclidean-descent
    algorithm, O(log) — the lattice-point count under a line."""
    ans = 0
    if a < 0:
        a2 = a % m
        ans -= n * (n - 1) // 2 * ((a2 - a) // m)
        a = a2
    if b < 0:
        b2 = b % m
        ans -= n * ((b2 - b) // m)
        b = b2
    while True:
        if a >= m:
            ans += n * (n - 1) // 2 * (a // m)
            a %= m
        if b >= m:
            ans += n * (b // m)
            b %= m
        y_max = a * n + b
        if y_max < m:
            return ans
        n = y_max // m
        b = y_max % m
        m, a = a, m


def _count_mod_lt(S0: int, N: int, b: int, C: int, T: int) -> int:
    """|{s in [S0, S0+N): (b*s) mod C < T}| for 0 <= T <= C, exactly:
    [y mod C < T] == floor(y/C) - floor((y-T)/C)."""
    if N <= 0 or T <= 0:
        return 0
    return _floor_sum(N, C, b, b * S0) - _floor_sum(N, C, b, b * S0 - T)


def max_bin_load(b: int, C: int, M: int, d: int) -> int:
    """Exact maximum number of source rows any single (sender, destination)
    pair carries under s -> (b*s) mod C, with sources and destinations
    blocked into 2^d contiguous device ranges of ls = 2^(M-d) rows and the
    identity region s >= C excluded."""
    D, ls = 1 << d, 1 << (M - d)
    best = 0
    for e in range(D):
        S0 = e * ls
        N = min(S0 + ls, C) - S0
        if N <= 0:
            break
        cuts = [_count_mod_lt(S0, N, b, C, min(m * ls, C)) for m in range(D + 1)]
        best = max(best, max(cuts[m + 1] - cuts[m] for m in range(D)))
    return best


def exchange_capacity(multipliers, C: int, M: int, d: int) -> int:
    """Static per-bin buffer capacity covering every step's multiplier:
    the exact max bin load, rounded up to a power of two (so trial-loop
    attempts with different (a, C) mostly reuse one compiled program).
    Multiplier 1 steps are identity and skip the exchange (lax.cond), so
    they are excluded here."""
    ls = 1 << (M - d)
    worst = max(
        (max_bin_load(int(b), C, M, d) for b in multipliers if int(b) != 1),
        default=1,
    )
    return min(ls, 1 << max(0, (max(worst, 1) - 1).bit_length())) or 1


# -- the on-device exchange -------------------------------------------------


def _oracle_exchange(a1, b, b_inv, C_s, me, *, M: int, d: int, cap: int):
    """The controlled modular-multiply permutation on the c=1 planes, as
    one balanced all_to_all (module docstring has the design).

    a1: (2, ls) local planes of the c=1 half.  b, b_inv, C_s: traced int32
    scalars with b*b_inv = 1 mod C_s.  Returns (new_a1, overflow) where
    overflow is the local count of bins exceeding cap (psum to surface)."""
    D = 1 << d
    n_l = M - d
    ls = 1 << n_l
    sloc = lax.iota(jnp.int32, ls)
    s_glob = me.astype(jnp.int32) * ls + sloc

    # --- sender: where does each local source row go? ----------------------
    w = xops.modmul_permute_onchip(b, s_glob, C_s, M)
    in_perm = s_glob < C_s
    # Identity rows (s >= C) stay local: sentinel bin D sorts them last and
    # they never enter the packed buffers.
    destdev = jnp.where(in_perm, lax.shift_right_logical(w, jnp.int32(n_l)), D)
    # Stable sort by destination: input rows are in source-index order, so
    # within each bin rows stay source-ascending — the exact order the
    # receiver reconstructs below.
    order = jnp.argsort(destdev, stable=True)
    sd = destdev[order]
    # int32 throughout (x64-mode searchsorted/argsort would widen to int64).
    starts = jnp.searchsorted(sd, lax.iota(jnp.int32, D + 1)).astype(jnp.int32)
    counts = starts[1:] - starts[:-1]
    overflow = jnp.sum((counts > cap).astype(jnp.int32), dtype=jnp.int32)
    # Pack (D, cap) send slots: slot (e, k) = k-th row of bin e (slots past
    # the bin count carry garbage; the receiver's own count masks them).
    k_idx = lax.broadcasted_iota(jnp.int32, (D, cap), 1)
    pos = jnp.clip(starts[:-1][:, None] + k_idx, 0, ls - 1)
    sendbuf = a1[:, order[pos]]                 # (2, D, cap)

    # --- the one collective ------------------------------------------------
    recvbuf = lax.all_to_all(sendbuf, AXIS, split_axis=1, concat_axis=1)

    # --- receiver: reconstruct each sender's packing order -----------------
    w_loc = lax.iota(jnp.int32, ls)
    w_glob = me.astype(jnp.int32) * ls + w_loc
    src = xops.modmul_permute_onchip(b_inv, w_glob, C_s, M)
    out_perm = w_glob < C_s
    srcdev = jnp.where(out_perm, lax.shift_right_logical(src, jnp.int32(n_l)), D)
    # Two-key sort (source device, source index): within each source
    # device's group this is source-ascending — identical to that sender's
    # stable packing, so group row k IS received slot (srcdev, k).
    sdev2, _, wl2 = lax.sort((srcdev, src, w_loc), num_keys=2)
    starts2 = jnp.searchsorted(sdev2, lax.iota(jnp.int32, D + 1)).astype(jnp.int32)
    rank = lax.iota(jnp.int32, ls) - starts2[jnp.minimum(sdev2, D)]
    exchanged = sdev2 < D
    addr = jnp.where(exchanged, sdev2 * cap + jnp.clip(rank, 0, cap - 1), 0)
    vals = recvbuf.reshape(2, D * cap)[:, addr]           # (2, ls)
    vals = jnp.where(exchanged[None, :], vals, a1[:, wl2])  # identity rows
    # wl2 is a permutation of the local rows: exactly one source per output.
    new_a1 = jnp.zeros_like(a1).at[:, wl2].set(vals)
    return new_a1, overflow


def _attempt_fn(L: int, M: int, d: int, rdtype, cap: int, mesh):
    """One whole semiclassical attempt on the mesh as ONE jitted shard_map
    fori_loop program, reset folded in (module docstring).

    (C, a_pows (L,), a_invs (L,), rs (L,), forces (L,)) ->
    (bits (L,) int32, conditional probs (L,), overflow int32)."""
    ls = 1 << (M - d)
    s2 = jnp.asarray(1.0 / math.sqrt(2.0), rdtype)
    cdt = _compute_dtype(rdtype)

    def body(s, carry):
        x, phi, bits, probs, oflow, C_s, a_pows, a_invs, rs, forces = carry
        me = lax.axis_index(AXIS)
        theta = (jnp.pi * phi).astype(cdt)
        # H on the control (implicit, enters in |0>): both branches are
        # x/sqrt2; only the c=1 branch feeds the oracle.
        a0 = x * s2
        # Controlled modular multiply on the c=1 branch — the one
        # collective.  The exchange moves rdtype amplitudes: at complex32
        # the wire carries HALF the ICI bytes of complex64.  Multiplier 1
        # (ord(a) | exponent) is the identity: skip, both because the
        # exchange is pointless and because its "bin load" would be the
        # whole shard (capacity excludes such steps).
        a1, of = lax.cond(
            a_pows[s] == 1,
            lambda operand: (operand, jnp.zeros((), jnp.int32)),
            lambda operand: _oracle_exchange(
                operand, a_pows[s], a_invs[s], C_s, me, M=M, d=d, cap=cap
            ),
            a0,
        )
        oflow = oflow + of
        # Deferred iQFT phase e^{i theta} on the c=1 branch: angle math in
        # cdt (f32 for bf16 storage), result stored back in rdtype.
        ct, st = jnp.cos(theta), jnp.sin(theta)
        a1 = jnp.stack([ct * a1[0] - st * a1[1], st * a1[0] + ct * a1[1]]).astype(rdtype)
        # Second H butterfly — consumed elementwise by the reductions and
        # the collapse pass; b0/b1 are never the carried state.
        b0 = (a0 + a1) * s2
        b1 = (a0 - a1) * s2
        # Measure the control: local partial sums + one psum per branch
        # (accumulated in cdt: 2^M-term sums at 8 mantissa bits would be
        # meaningless).
        p0 = lax.psum(jnp.sum(b0[0].astype(cdt) ** 2 + b0[1].astype(cdt) ** 2), AXIS)
        p1 = lax.psum(jnp.sum(b1[0].astype(cdt) ** 2 + b1[1].astype(cdt) ** 2), AXIS)
        total = p0 + p1
        bit = (rs[s] * total >= p0).astype(jnp.int32)
        bit = jnp.where(forces[s] >= 0, forces[s], bit)
        p_branch = jnp.where(bit == 1, p1, p0)
        # Collapse, renormalize, and reset c to |0> in one elementwise pass
        # (reference measure/collapse/no-remeasure semantics per bit):
        # (-1)^bit as an exact sign keeps a0 + sign*a1 bitwise a0 +/- a1.
        sign = (1 - 2 * bit).astype(rdtype)
        x = (a0 + sign * a1) * s2 / jnp.sqrt(p_branch).astype(rdtype)
        phi = (phi + bit.astype(cdt)) / 2
        return (
            x, phi, bits.at[s].set(bit),
            probs.at[s].set((p_branch / total).astype(cdt)),
            oflow, C_s, a_pows, a_invs, rs, forces,
        )

    def attempt(C_s, a_pows, a_invs, rs, forces):
        me = lax.axis_index(AXIS)
        # |1>: work register = 1 (device 0, local row 1); the control is
        # implicit — reset_register semantics, built in the (plane, w)
        # layout.
        row = ((me == 0) & (lax.iota(jnp.int32, ls) == 1)).astype(rdtype)
        x = jnp.zeros((2, ls), rdtype).at[0].set(row)
        carry = (
            x, jnp.zeros((), cdt),
            jnp.zeros((L,), jnp.int32), jnp.zeros((L,), cdt),
            jnp.zeros((), jnp.int32), C_s, a_pows, a_invs, rs, forces,
        )
        _, _, bits, probs, oflow, *_ = lax.fori_loop(0, L, body, carry)
        return bits, probs, lax.psum(oflow, AXIS)

    smapped = jax.shard_map(
        attempt,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(smapped)


# -- host driver ------------------------------------------------------------

# Per-chip peak of the fused sharded attempt, in local-shard units: the
# (2, ls) shard, the rotated branch a1, the all_to_all send+recv exchange
# buffers (~1 shard each at the balanced capacity), and fori_loop carry
# double-buffering.  Conservative (validated against the single-chip
# _FUSED_STATES_HEADROOM=4 + exchange; unmeasured on real multi-chip).
_SHARD_STATES_HEADROOM = 6


def sharded_attempt_fits(M: int, rdtype, d: int) -> bool:
    """Does one fused sharded attempt at M work-qubits fit a 2^d-device
    mesh of this chip?  Mirrors semiclassical.fused_attempt_fits for the
    mesh: the budget check the driver runs BEFORE dispatch, so an
    oversized shard raises a descriptive ValueError instead of an opaque
    RESOURCE_EXHAUSTED mid-attempt."""
    from quantumcomputer.utils.memory import device_hbm_budget

    shard_bytes = 2 * (1 << (M - d)) * jnp.dtype(rdtype).itemsize
    return _SHARD_STATES_HEADROOM * shard_bytes <= device_hbm_budget()


def run_semiclassical_sharded(
    C: int,
    a: int,
    L: int,
    M: int,
    key: jax.Array,
    mesh,
    dtype=jnp.complex64,
    forced_bits: Optional[List[int]] = None,
    _cache: dict = {},
) -> SemiclassicalRecord:
    """One semiclassical period-finding attempt with the work register
    sharded over `mesh` — the multi-chip form of
    algorithms.semiclassical.run_semiclassical (same record type, same
    measurement semantics, same draw stream given the same key)."""
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary")
    if C >= (1 << MAX_MODULUS_BITS):
        raise ValueError(
            f"C={C} >= 2^{MAX_MODULUS_BITS} exceeds the int32 shift-add "
            "modular-arithmetic bound (ops/gates.modmul_onchip)"
        )
    if M > MAX_MODULUS_BITS:
        raise ValueError(f"M={M} > {MAX_MODULUS_BITS} exceeds the int32 index budget")
    if L > 52:
        raise ValueError(f"L={L} > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)")
    if math.gcd(a, C) != 1:
        raise ValueError(f"a={a} not coprime to C={C}: gate is not a permutation")
    d = mesh_degree(mesh)
    if M - d < 1:
        raise ValueError(f"M={M} too small for 2^{d} devices (no local work rows)")
    rdtype = sv.real_dtype_of(dtype)
    if not sharded_attempt_fits(M, rdtype, d):
        from quantumcomputer.utils.memory import device_hbm_budget

        raise ValueError(
            f"M={M} at {jnp.dtype(rdtype).name} needs ~"
            f"{_SHARD_STATES_HEADROOM * 2 * (1 << (M - d)) * jnp.dtype(rdtype).itemsize / 2**30:.1f} GiB "
            f"per chip (shard + exchange buffers + fori_loop double-buffer) — "
            f"exceeds the {device_hbm_budget() / 2**30:.1f} GiB device budget. "
            f"Use more devices, complex32, or a smaller M."
        )

    # Step s applies the controlled a^(2^(L-1-s)) mod C multiply; the
    # multipliers, inverses, and exact exchange capacity are the only host
    # work (Python bigints + O(D^2 log C) lattice counts — no 2^M arrays).
    a_pows = np.asarray([pow(a, 1 << (L - 1 - s), C) for s in range(L)], np.int32)
    a_invs = np.asarray([pow(int(p), -1, C) for p in a_pows], np.int32)
    cap = exchange_capacity(a_pows, C, M, d)
    rs = jax.random.uniform(key, (L,), dtype=_compute_dtype(rdtype))
    forces = np.full((L,), -1, np.int32)
    forced_bits = validate_forced_bits(forced_bits, L, "L")
    if forced_bits is not None:
        forces = np.asarray(forced_bits, np.int32)

    # Key by mesh CONTENT (device ids + axes), not id(mesh): a process that
    # builds a fresh Mesh per call would otherwise accumulate one pinned
    # (mesh, compiled program) pair per invocation forever; identical
    # meshes legitimately share the compiled program.  Bounded as a
    # backstop against many distinct geometries in one process.
    mesh_key = (tuple(dev.id for dev in mesh.devices.flat), mesh.axis_names)
    ck = (L, M, d, cap, jnp.dtype(rdtype).name, mesh_key)
    fn = _cache.get(ck)
    if fn is None:
        if len(_cache) >= 32:
            _cache.pop(next(iter(_cache)))  # FIFO evict
        fn = _cache[ck] = _attempt_fn(L, M, d, rdtype, cap, mesh)

    bits_d, probs_d, oflow = fn(
        jnp.asarray(C, jnp.int32), jnp.asarray(a_pows),
        jnp.asarray(a_invs), rs, jnp.asarray(forces),
    )
    if int(oflow) != 0:
        raise RuntimeError(
            "oracle exchange bin overflow: a destination bin exceeded the "
            f"computed capacity {cap} — the host lattice count and the "
            "device permutation disagree (bug); amplitudes were NOT "
            "silently dropped, this run is void"
        )
    bits = [int(b) for b in np.asarray(bits_d)]
    probs = [float(p) for p in np.asarray(probs_d)]
    return SemiclassicalRecord.from_bits(bits, probs)
