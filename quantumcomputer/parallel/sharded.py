"""Sharded state-vector engine: multi-chip gate application via shard_map.

The planar (2, 2^n) state is sharded over its amplitude axis (see
parallel/mesh.py): the top d qubits are *global* (bit value = device
coordinate), the low n-d qubits are shard-local.  One circuit = one
jitted shard_map program:

  * gates on local qubits  -> the single-chip ops, unchanged, per shard;
  * dense gates on a global qubit -> one collective_permute (ppermute) of
    the whole local shard with the partner device (the butterfly exchange),
    then a 2-term linear combination selected by this device's bit;
  * diagonal gates on global qubits -> no communication at all: the device
    bit is a compile-time-known function of axis_index, so the phase is a
    scalar/vector select;
  * the controlled modular-multiply with a global control -> no
    communication: each device applies the M-register gather or the
    identity according to its own control bit;
  * measurement -> per-shard |amp|^2 totals, all_gather of D partial sums,
    device-level inverse-CDF pick, then local inverse-CDF within the
    chosen shard (equivalent to the reference's global serial scan,
    qc_shor.c:272-306).

The reference is single-threaded (Report §IV.D names parallelization as
future work); this engine is the device-mesh realization of that future
work: qubit count scales with device count (n = n_local + log2(#devices)).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from quantumcomputer.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer.ops import gates as xops
from quantumcomputer.parallel.mesh import AXIS, build_mesh, mesh_degree, state_sharding
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register


def _butterfly_pairs(D: int, p: int):
    """ppermute pairing for global-qubit bit p: k <-> k XOR 2^p."""
    return [(k, k ^ (1 << p)) for k in range(D)]


def _device_bit(me, p: int):
    return (me >> p) & 1


def _apply_1q_global(z, u2: np.ndarray, p: int, me, D: int):
    """Dense 1q gate on global qubit bit p: exchange shards with the partner
    device, then new = U[b,b] * ours + U[b,1-b] * theirs (b = our bit)."""
    remote = lax.ppermute(z, AXIS, _butterfly_pairs(D, p))
    b = _device_bit(me, p)
    dtype = z.dtype
    diag = jnp.where(b == 0, jnp.asarray(u2[0, 0], dtype), jnp.asarray(u2[1, 1], dtype))
    off = jnp.where(b == 0, jnp.asarray(u2[0, 1], dtype), jnp.asarray(u2[1, 0], dtype))
    return diag * z + off * remote


def _apply_2q_one_global(z, u4: np.ndarray, p: int, q_local: int, me, D: int):
    """Dense 2q gate where exactly one qubit is global (device bit p) and the
    other is shard-local.  u4 must be in the basis 2*bit(global) + bit(local).
    One shard exchange + a contraction over (global, local) pairs."""
    remote = lax.ppermute(z, AXIS, _butterfly_pairs(D, p))
    b = _device_bit(me, p)
    dtype = z.dtype
    dim = z.shape[0]
    inner = 1 << q_local
    outer = dim // (2 * inner)
    x_me = z.reshape(outer, 2, inner)
    x_rm = remote.reshape(outer, 2, inner)
    u = jnp.asarray(u4, dtype).reshape(2, 2, 2, 2)  # (g', l', g, l)
    # Row block for our output bit b: W[l', g, l] = U[b, l', g, l].
    w = jnp.where(b == 0, u[0], u[1])
    # Stack inputs by their global-bit value: index a=0 -> amplitude with
    # global bit 0.  Ours carries bit b, the remote carries 1-b.
    s_b0 = jnp.stack([x_me, x_rm])  # if b == 0
    s_b1 = jnp.stack([x_rm, x_me])  # if b == 1
    xs = jnp.where(b == 0, s_b0, s_b1)  # (g=a, outer, l, inner)
    out = jnp.einsum("fgl,golx->ofx", w, xs, precision=jax.lax.Precision.HIGHEST)
    return out.reshape(dim)


def _apply_2q_both_global(z, u4: np.ndarray, p_hi: int, p_lo: int, me, D: int):
    """Dense 2q gate with BOTH qubits globally sharded (device bits p_hi,
    p_lo).  Each device needs the shards of its 3 XOR-partners — three
    collective_permutes — then a 4-term combination selected by this
    device's two bits.  u4 is in the 2*bit(hi) + bit(lo) basis."""
    dtype = z.dtype
    r_lo = lax.ppermute(z, AXIS, _butterfly_pairs(D, p_lo))
    r_hi = lax.ppermute(z, AXIS, _butterfly_pairs(D, p_hi))
    r_both = lax.ppermute(r_lo, AXIS, _butterfly_pairs(D, p_hi))
    b_hi = _device_bit(me, p_hi)
    b_lo = _device_bit(me, p_lo)
    row = 2 * b_hi + b_lo
    u = jnp.asarray(u4, dtype)  # (4, 4)
    # Our output row of the 4x4, selected by the traced row index.
    urow = jnp.where(
        row == 0, u[0], jnp.where(row == 1, u[1], jnp.where(row == 2, u[2], u[3]))
    )  # (4,)
    out = jnp.zeros_like(z)
    for d_hi in (0, 1):
        for d_lo in (0, 1):
            src = (z, r_lo, r_hi, r_both)[2 * d_hi + d_lo]
            col = 2 * (b_hi ^ d_hi) + (b_lo ^ d_lo)
            out = out + urow[col] * src
    return out


def _apply_diag_global_scalar(z, diag_val_one, diag_val_zero, bit):
    dtype = z.dtype
    f = jnp.where(bit == 1, jnp.asarray(diag_val_one, dtype), jnp.asarray(diag_val_zero, dtype))
    return z * f


# ---------------------------------------------------------------------------
# Planar-pair mesh path: the bf16 "complex32" storage mode across devices.
#
# bf16 has no complex dtype, so the sharded engine threads separate re/im
# planes through shard_map (mirroring the single-chip planar-pair path,
# sim/engine.apply_circuit_planes).  Design invariants (ROADMAP r2 item 2):
#   * every shard exchange moves BOTH planes in one logical ppermute (a
#     pytree collective: two half-width transfers, no stack/unstack HBM
#     pass) — the exchange volume is HALF the complex64 path's;
#   * every arithmetic blend upcasts to f32 INSIDE the expression
#     (`(c * re.astype(f32) ...).astype(bf16)` is one fused XLA pass over
#     bf16 buffers), so precision is f32 everywhere while HBM traffic
#     stays at bf16 width;
#   * shard-local gates reuse the single-device planes dispatch
#     (sim/engine.apply_gate_planes: f32 compute, bf16 store).
# f32/f64 states keep the complex path above (real/imag are free there and
# the compiled programs are identical); these helpers are dtype-generic
# anyway so the planes path can serve any plane dtype.


def _acc_dtype(rdtype):
    return jnp.float32 if rdtype == jnp.bfloat16 else rdtype


def _ppermute_planes(re, im, perm):
    """Exchange both planes with the partner device in one logical
    collective (pytree ppermute: two same-schedule transfers, half the
    bytes each vs one complex64 shard — total ICI volume halves).

    The optimization barrier pins the collective to the STORAGE dtype:
    without it XLA hoists the blend's bf16->f32 convert across the
    collective-permute (convert(ppermute(x)) -> ppermute(convert(x))),
    silently doubling the wire bytes — the exact regression
    test_c32_halves_collective_bytes_vs_c64 guards."""
    out = lax.ppermute((re, im), AXIS, perm)
    if jnp.dtype(re.dtype) == jnp.bfloat16:
        out = lax.optimization_barrier(out)
    return out


def _select_entry(b, m00, m11):
    """where(b==0, m00, m11) for numpy complex scalars -> (re, im) pair."""
    return (
        jnp.where(b == 0, float(np.real(m00)), float(np.real(m11))),
        jnp.where(b == 0, float(np.imag(m00)), float(np.imag(m11))),
    )


def _apply_1q_global_planes(re, im, u2: np.ndarray, p: int, me, D: int):
    """Dense 1q gate on global qubit bit p, planar-pair form: one plane-pair
    exchange, then new = U[b,b]*ours + U[b,1-b]*theirs with the f32 upcast
    fused into the blend (cf. _apply_1q_global)."""
    rre, rim = _ppermute_planes(re, im, _butterfly_pairs(D, p))
    b = _device_bit(me, p)
    cdt = _acc_dtype(re.dtype)
    dr, di = _select_entry(b, u2[0, 0], u2[1, 1])
    orr, oi = _select_entry(b, u2[0, 1], u2[1, 0])
    dr, di, orr, oi = (v.astype(cdt) for v in (dr, di, orr, oi))
    reF, imF = re.astype(cdt), im.astype(cdt)
    rreF, rimF = rre.astype(cdt), rim.astype(cdt)
    out_re = dr * reF - di * imF + orr * rreF - oi * rimF
    out_im = dr * imF + di * reF + orr * rimF + oi * rreF
    return out_re.astype(re.dtype), out_im.astype(re.dtype)


def _apply_diag_global_scalar_planes(re, im, diag_one, diag_zero, bit):
    """z *= (bit ? diag_one : diag_zero) on planes, f32-blended."""
    cdt = _acc_dtype(re.dtype)
    fr, fi = _select_entry(1 - bit, diag_one, diag_zero)  # bit==1 -> one
    fr, fi = fr.astype(cdt), fi.astype(cdt)
    reF, imF = re.astype(cdt), im.astype(cdt)
    return (fr * reF - fi * imF).astype(re.dtype), (fr * imF + fi * reF).astype(re.dtype)


def _apply_diag_1q_planes(re, im, dr2, di2, q: int):
    """Diagonal 1q gate on a LOCAL qubit, planes form: dr2/di2 are (2,)
    re/im parts of the diagonal (possibly traced selections)."""
    cdt = _acc_dtype(re.dtype)
    dim = re.shape[0]
    inner = 1 << q
    outer = dim // (2 * inner)
    dr = jnp.asarray(dr2, cdt).reshape(1, 2, 1)
    di = jnp.asarray(di2, cdt).reshape(1, 2, 1)
    reF = re.reshape(outer, 2, inner).astype(cdt)
    imF = im.reshape(outer, 2, inner).astype(cdt)
    nre = (dr * reF - di * imF).astype(re.dtype).reshape(dim)
    nim = (dr * imF + di * reF).astype(re.dtype).reshape(dim)
    return nre, nim


def _rotate_gather_rows_planes(xr, xi, srow_loc, sdev_loc, deltas, me, D: int):
    """Planar-pair twin of _rotate_gather_rows: each rotation round ships
    both planes in one logical collective."""
    accr, acci = xr, xi
    for delta in deltas:
        if delta == 0:
            inr, ini, src = xr, xi, me
        else:
            inr, ini = _ppermute_planes(xr, xi, [(p, (p + delta) % D) for p in range(D)])
            src = (me - delta) % D
        mask = (sdev_loc == src)[:, None]
        accr = jnp.where(mask, jnp.take(inr, srow_loc, axis=0), accr)
        acci = jnp.where(mask, jnp.take(ini, srow_loc, axis=0), acci)
    return accr, acci


def apply_gate_sharded_planes(re, im, g: Gate, *, n: int, M: int, d: int, me, tables=(), routes=()):
    """Planar-pair twin of apply_gate_sharded: dispatch one gate on local
    (2^(n-d),) re/im planes.  Shard-local gates reuse the single-device
    planes dispatch; gates on globally-sharded qubits use the fused-upcast
    blend helpers above."""
    from quantumcomputer.sim.engine import apply_gate_planes

    n_local = n - d
    D = 1 << d

    def is_global(q):
        return q >= n_local

    name = g.name
    if name in DENSE_1Q:
        q = g.qubits[0]
        if not is_global(q):
            return apply_gate_planes(re, im, g, M, tables=tables)
        return _apply_1q_global_planes(re, im, gate_matrix_1q(g), q - n_local, me, D)

    if name in DIAGONAL_1Q:
        dg = np.diagonal(gate_matrix_1q(g))
        q = g.qubits[0]
        if not is_global(q):
            return _apply_diag_1q_planes(re, im, dg.real, dg.imag, q)
        return _apply_diag_global_scalar_planes(re, im, dg[1], dg[0], _device_bit(me, q - n_local))

    if name in ("cz", "cphase"):
        d4 = np.diagonal(gate_matrix_2q(g))
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        hi_g, lo_g = is_global(q_hi), is_global(q_lo)
        if not hi_g and not lo_g:
            return apply_gate_planes(re, im, g, M, tables=tables)
        if hi_g and lo_g:
            b_hi = _device_bit(me, q_hi - n_local)
            b_lo = _device_bit(me, q_lo - n_local)
            idx = 2 * b_hi + b_lo
            fr = jnp.asarray(d4.real)[idx]
            fi = jnp.asarray(d4.imag)[idx]
            cdt = _acc_dtype(re.dtype)
            reF, imF = re.astype(cdt), im.astype(cdt)
            fr, fi = fr.astype(cdt), fi.astype(cdt)
            return (fr * reF - fi * imF).astype(re.dtype), (fr * imF + fi * reF).astype(re.dtype)
        if hi_g:
            b = _device_bit(me, q_hi - n_local)
            dr2 = jnp.where(b == 0, jnp.asarray(d4[:2].real), jnp.asarray(d4[2:].real))
            di2 = jnp.where(b == 0, jnp.asarray(d4[:2].imag), jnp.asarray(d4[2:].imag))
            return _apply_diag_1q_planes(re, im, dr2, di2, q_lo)
        b = _device_bit(me, q_lo - n_local)
        dr2 = jnp.where(b == 0, jnp.asarray(d4[[0, 2]].real), jnp.asarray(d4[[1, 3]].real))
        di2 = jnp.where(b == 0, jnp.asarray(d4[[0, 2]].imag), jnp.asarray(d4[[1, 3]].imag))
        return _apply_diag_1q_planes(re, im, dr2, di2, q_hi)

    if name == "mcphase":
        # Diagonal everywhere: global control bits are a per-device scalar
        # condition (communication-free), local bits a masked elementwise
        # rotation with the blend computed in the accumulation dtype.
        theta = float(g.params[0])
        mask = 0
        cond = None
        for q in g.qubits:
            if is_global(q):
                b = _device_bit(me, q - n_local) == 1
                cond = b if cond is None else (cond & b)
            else:
                mask |= 1 << q
        idx = lax.iota(jnp.int32, re.shape[-1])
        hit = (idx & jnp.int32(mask)) == jnp.int32(mask)
        if cond is not None:
            hit = hit & cond
        cdt = _acc_dtype(re.dtype)
        c = jnp.asarray(np.cos(theta), cdt)
        s = jnp.asarray(np.sin(theta), cdt)
        reF, imF = re.astype(cdt), im.astype(cdt)
        return (
            jnp.where(hit, c * reF - s * imF, reF).astype(re.dtype),
            jnp.where(hit, c * imF + s * reF, imF).astype(re.dtype),
        )

    if name in ("camodc", "camodc_slot"):
        c_q = g.qubits[0]
        assert M <= n_local, "M register must be shard-local"
        if not is_global(c_q):
            return apply_gate_planes(re, im, g, M, tables=tables)
        if name == "camodc":
            C, atox = g.meta
            ginv = jnp.asarray(xops.modmul_inverse_permutation(C, atox, M))
        else:
            ginv = tables[g.meta[0]]
        m_dim = 1 << M
        ctrl = _device_bit(me, c_q - n_local)

        def permute_plane(x):
            permuted = jnp.take(x.reshape(-1, m_dim), ginv, axis=-1).reshape(x.shape)
            return jnp.where(ctrl == 1, permuted, x)

        return permute_plane(re), permute_plane(im)

    if name in ("camodc_high", "camodc_high_slot"):
        # m_high oracle, planes form (cf. the complex branches above): the
        # static form uses the packed-row exchange (~1R+1W + ~one shard of
        # ICI); the slot form uses the same packed traffic with TRACED
        # routing operands when `routes` are bound (packed_slot_routes),
        # else the D-round rotation (table-only compile-once fallback).
        if d == 0:
            return apply_gate_planes(re, im, g, M, tables=tables)
        c_phys = g.qubits[0]
        if name == "camodc_high":
            C, atox, m_reg = g.meta
            assert d <= m_reg, "m_high sharding needs the global bits inside the M register"
            rest = 1 << (n - m_reg)
            R = (1 << m_reg) >> d
            xr = re.reshape(R, rest)
            xi = im.reshape(R, rest)
            accr, acci = _apply_rows_packed((xr, xi), int(C), int(atox), m_reg, d, me)
        else:
            slot, m_reg = g.meta
            assert d <= m_reg, "m_high sharding needs the global bits inside the M register"
            rest = 1 << (n - m_reg)
            R = (1 << m_reg) >> d
            xr = re.reshape(R, rest)
            xi = im.reshape(R, rest)
            if routes and routes[slot] is not None:
                # Hybrid packed form: traced routing operands, static round
                # structure (packed_slot_routes) — compile-once AND packed.
                local_tab, send_tab, recv_tab = routes[slot]
                accr, acci = _apply_rows_packed_traced(
                    (xr, xi),
                    jnp.take(local_tab, me, axis=0),
                    jnp.take(send_tab, me, axis=0),
                    jnp.take(recv_tab, me, axis=0),
                    D,
                )
            else:
                ginv = tables[slot]
                sdev_loc = lax.dynamic_slice_in_dim(ginv // R, me * R, R)
                srow_loc = lax.dynamic_slice_in_dim(ginv % R, me * R, R)
                accr, acci = _rotate_gather_rows_planes(xr, xi, srow_loc, sdev_loc, range(D), me, D)
        col = lax.iota(jnp.int32, rest)
        ctrl = (((col >> c_phys) & 1) == 1)[None, :]
        return (
            jnp.where(ctrl, accr, xr).reshape(re.shape),
            jnp.where(ctrl, acci, xi).reshape(im.shape),
        )

    if name == "camodc_ladder_high":
        C, m_reg = g.meta[0], g.meta[1]
        A_list = g.meta[2:]
        controls = g.qubits
        if d == 0:
            return apply_gate_planes(re, im, g, M, tables=tables)
        assert d <= m_reg
        from quantumcomputer.ops.gates import modexp_combo_multipliers

        rest = 1 << (n - m_reg)
        R = (1 << m_reg) >> d
        combos = jnp.asarray(modexp_combo_multipliers(C, A_list), jnp.int32)
        col = lax.iota(jnp.int32, rest)
        bits = jnp.zeros_like(col)
        for k, c in enumerate(controls):
            bits = bits | (((col >> c) & 1) << k)
        mult = combos[bits]
        xr = re.reshape(R, rest)
        xi = im.reshape(R, rest)
        f_out = (me * R + lax.iota(jnp.int32, R))[:, None]
        src = jnp.where(f_out < C, (mult[None, :] * f_out) % C, f_out)
        src_dev = src // R
        src_loc = src % R
        accr, acci = xr, xi
        for delta in range(D):
            if delta == 0:
                inr, ini, src_of = xr, xi, me
            else:
                inr, ini = _ppermute_planes(xr, xi, [(p, (p + delta) % D) for p in range(D)])
                src_of = (me - delta) % D
            hit = src_dev == src_of
            accr = jnp.where(hit, jnp.take_along_axis(inr, src_loc, axis=0), accr)
            acci = jnp.where(hit, jnp.take_along_axis(ini, src_loc, axis=0), acci)
        return accr.reshape(re.shape), acci.reshape(im.shape)

    if name == "iqft_stage":
        l = g.qubits[0]
        if not is_global(l):
            return apply_gate_planes(re, im, g, M, tables=tables)
        re, im = _apply_1q_global_planes(re, im, _H64(), l - n_local, me, D)
        if l > M:
            cdt = _acc_dtype(re.dtype)
            ls = re.shape[0]
            mask = (1 << l) - (1 << M)
            masked = lax.iota(jnp.int32, ls) & mask  # int32-safe split, cf. complex branch
            if l > n_local:
                masked = masked + ((me & ((1 << (l - n_local)) - 1)) << n_local)
            frac = masked.astype(cdt) * (np.pi / float(1 << l))
            pc, ps = jnp.cos(frac), jnp.sin(frac)
            reF, imF = re.astype(cdt), im.astype(cdt)
            nre = (pc * reF - ps * imF).astype(re.dtype)
            nim = (pc * imF + ps * reF).astype(re.dtype)
            bit_l = _device_bit(me, l - n_local)
            re = jnp.where(bit_l == 1, nre, re)
            im = jnp.where(bit_l == 1, nim, im)
        return re, im

    if name in ("cnot", "swap", "u2q") and all(not is_global(q) for q in g.qubits):
        # Shard-local dense 2q: the single-chip planes dispatch (u2q fused
        # kernel, or its upcast fallback) — never the complex round-trip.
        return apply_gate_planes(re, im, g, M, tables=tables)

    # Rare GLOBAL dense 2q forms (cnot/swap/u2q with a device-bit qubit):
    # route through the complex helpers at f32 (one upcast pass; these
    # never appear in the Shor hot path, where the oracle/iQFT forms above
    # cover everything).
    cdt = _acc_dtype(re.dtype)
    z = lax.complex(re.astype(cdt), im.astype(cdt))
    z = apply_gate_sharded(z, g, n=n, M=M, d=d, me=me, tables=tables, routes=routes)
    return jnp.real(z).astype(re.dtype), jnp.imag(z).astype(re.dtype)


def _fuse_mhigh_ladders(circuit, M: int, d: int):
    """Fuse m_high oracle runs into composed ladders — but ONLY runs of
    K >= D = 2^d: a fused ladder pays (D-1) full-shard ppermute rounds
    while K packed singles pay ~K*(D-1)/D shards, so fusing shorter runs
    moves MORE bytes (fuse_oracle_ladders min_run; ROADMAP item 2).
    Eligibility keeps combo*f inside int32 (the kernels' index bound).
    Shared by the complex and bf16-planes appliers so the two dtype modes
    always fuse identical circuits."""
    from quantumcomputer.sim.engine import fuse_oracle_ladders

    def _eligible(g: Gate) -> bool:
        return g.name == "camodc_high" and g.meta[0] * (1 << g.meta[2]) < (1 << 31)

    return fuse_oracle_ladders(circuit, M, eligible=_eligible, min_run=1 << d)


def apply_circuit_sharded_planes(
    re, im, circuit: Circuit, *, n: int, M: int, d: int, me,
    fuse: bool = True, trace_norms: bool = False, tables=(), routes=(),
):
    """Planar-pair twin of apply_circuit_sharded (the bf16 'complex32' mesh
    path): one gate per pass via apply_gate_sharded_planes.  Norms
    accumulate in f32."""
    norms: list = []
    acc = _acc_dtype(re.dtype)

    def step_done(r, i_):
        if trace_norms:
            norms.append(lax.psum(jnp.sum(r.astype(acc) ** 2) + jnp.sum(i_.astype(acc) ** 2), AXIS))
        return r, i_

    if fuse:
        circuit = _fuse_mhigh_ladders(circuit, M, d)

    for g in circuit:
        re, im = step_done(*apply_gate_sharded_planes(re, im, g, n=n, M=M, d=d, me=me, tables=tables, routes=routes))
    return ((re, im), norms) if trace_norms else (re, im)


def two_level_pick(probs, scaled_r, scale_by_total: bool = False):
    """THE shared sharded inverse-CDF pick (equivalent to the reference's
    global serial scan, qc_shor.c:272-306): device-level pick over
    all-gathered shard totals, then in-shard pick.  Used by the complex,
    complex32, and dd64 mesh engines — keep them on one implementation so
    the measurement semantics cannot silently diverge.

    `scaled_r` is the caller's draw on the caller's probability scale (the
    complex engines pass the raw uniform — their states are normalized).
    `scale_by_total=True` instead scales a raw uniform by the GLOBAL
    probability total here, from the totals this pick already gathers —
    one collective instead of a caller-side psum plus the gather (the dd
    engine's statistical-accuracy scaling).  Returns the measured GLOBAL
    index as an int32 (device, local) PAIR: the full index dev*ls + loc
    can exceed int32 at n = 32 without x64, so the two components
    compose on the HOST (Python ints are arbitrary-precision) — see
    tests/test_index_width.py."""
    me = lax.axis_index(AXIS)
    ls = probs.shape[-1]
    totals = lax.all_gather(jnp.sum(probs), AXIS)  # (D,)
    cum_dev = jnp.cumsum(totals)
    if scale_by_total:
        scaled_r = scaled_r * cum_dev[-1]
    dev = jnp.minimum(jnp.searchsorted(cum_dev, scaled_r, side="left"), totals.shape[0] - 1)
    offset = cum_dev[dev] - totals[dev]
    local_cum = jnp.cumsum(probs)
    local_idx = jnp.minimum(
        jnp.searchsorted(local_cum, scaled_r - offset, side="left"), ls - 1
    )
    # dev is identical on every shard (same draw, same gathered totals);
    # only the owning shard knows the local pick.
    loc = lax.psum(jnp.where(me == dev, local_idx.astype(jnp.int32), 0), AXIS)
    return dev.astype(jnp.int32), loc


def _measure_index_planes(re, im, key):
    """Measurement body for the complex/complex32 mesh engines: f32-
    accumulated probabilities from re/im planes (no stacked copy), raw
    uniform draw (states are normalized), shared two-level pick.  The
    index math is (device, local)-split throughout — no global-width
    parameter is needed."""
    acc = _acc_dtype(re.dtype)
    probs = re.astype(acc) ** 2 + im.astype(acc) ** 2
    r = jax.random.uniform(key, dtype=acc)  # same key -> same r on all shards
    return two_level_pick(probs, r)


def _collapse_planes(dev, loc, me, ls: int, dtype):
    """One-hot collapsed planar shard for measured (device, local) index —
    pure int32 compares, no global index materialized."""
    onehot = ((me == dev) & (lax.iota(jnp.int32, ls) == loc)).astype(dtype)
    return jnp.stack([onehot, jnp.zeros_like(onehot)])


def _measure_local(planar, key):
    """Measurement + collapse from a local planar shard (draws and
    accumulation follow the plane dtype)."""
    me = lax.axis_index(AXIS)
    ls = planar.shape[-1]
    dev, loc = _measure_index_planes(planar[0], planar[1], key)
    return dev, loc, _collapse_planes(dev, loc, me, ls, planar.dtype)


def apply_circuit_sharded(
    z, circuit: Circuit, *, n: int, M: int, d: int, me,
    fuse: bool = True, trace_norms: bool = False, tables=(), routes=(),
):
    """Apply a circuit to the local shard, one gate per pass: shard-local
    gates are the single-chip XLA ops, gates touching globally-sharded
    qubits run their collectives.

    trace_norms=True also returns the psum'd post-gate norm list — the
    FIG. 2 probability-conservation oracle on the production path."""
    norms: list = []

    def step_done(zz):
        if trace_norms:
            norms.append(lax.psum(jnp.sum(jnp.real(zz * jnp.conj(zz))), AXIS))
        return zz

    if fuse:
        circuit = _fuse_mhigh_ladders(circuit, M, d)

    for g in circuit:
        z = step_done(apply_gate_sharded(z, g, n=n, M=M, d=d, me=me, tables=tables, routes=routes))
    return (z, norms) if trace_norms else z


from functools import lru_cache


def _fill_offset_routes(src, delta_of, D: int, R: int, delta: int, send_idx, recv_dst):
    """Fill one offset's packed send/recv tables IN PLACE ((D, K) views).
    The ONE home of the routing convention — send padding gathers row 0,
    recv padding points at row R (dropped by scatter mode='drop'), sender
    p = (receiver - delta) % D, rows ordered as the receiver expects —
    shared by the static schedule and the slot-route builder so the two
    packed forms cannot silently diverge."""
    for k in range(D):  # receiver
        g = np.nonzero(delta_of[k * R:(k + 1) * R] == delta)[0]  # local dst rows
        p = (k - delta) % D  # sender
        send_idx[p, : g.size] = (src[k * R + g] % R).astype(np.int32)
        recv_dst[k, : g.size] = g.astype(np.int32)


def _local_source_rows(src, delta_of, D: int, R: int, rows):
    """local_idx[k][r]: shard-local source row when it lives on k, else r
    (identity placeholder, overwritten by the exchange scatter)."""
    return np.where(delta_of == 0, src % R, rows % R).reshape(D, R).astype(np.int32)


@lru_cache(maxsize=256)
def _packed_exchange_schedule(C: int, atox: int, m_reg: int, d: int):
    """Static routing tables for the m_high oracle row exchange
    (VERDICT r2 item 2): the permutation f -> A*f mod C on global rows is
    compile-time known, so each device ships each partner ONLY the rows it
    needs, padded per-offset to the max count across devices.

    Returns (local_idx (D, R), schedule) where schedule is a tuple of
    (delta, send_idx (D, K_delta), recv_dst (D, K_delta)) for every used
    nonzero offset:
      * local_idx[k][r] = the shard-local source row when it lives on k,
        else r (identity placeholder, overwritten by the scatter);
      * send_idx[p] = rows device p gathers and sends to p+delta, ordered
        as the receiver expects (padding sends row 0);
      * recv_dst[p] = where device p scatters the buffer it receives from
        p-delta (padding points at row R -> dropped by scatter mode).

    Total ICI volume = sum_delta K_delta rows ~ R * (D-1)/D for the
    near-uniform modular-multiply permutation — vs D full shards for the
    rotate-blend form this replaces."""
    from quantumcomputer.ops.gates import modmul_inverse_permutation

    D = 1 << d
    R = (1 << m_reg) >> d
    src = np.asarray(modmul_inverse_permutation(C, atox, m_reg), np.int64)
    rows = np.arange(D * R, dtype=np.int64)
    src_dev = src // R
    dst_dev = rows // R
    delta_of = (dst_dev - src_dev) % D

    local_idx = _local_source_rows(src, delta_of, D, R, rows)

    schedule = []
    for delta in range(1, D):
        # receiver k's rows from src_dev k-delta, sender p = k-delta
        counts = [int(np.sum(delta_of[k * R:(k + 1) * R] == delta)) for k in range(D)]
        K = max(counts)
        if K == 0:
            continue
        send_idx = np.zeros((D, K), np.int32)
        recv_dst = np.full((D, K), R, np.int32)  # R = out-of-bounds -> dropped
        _fill_offset_routes(src, delta_of, D, R, delta, send_idx, recv_dst)
        schedule.append((delta, send_idx, recv_dst))
    return local_idx, tuple(schedule)


def _apply_rows_packed(planes, C: int, atox: int, m_reg: int, d: int, me):
    """Apply the m_high oracle row exchange to (R, rest)-shaped plane
    arrays via the packed static schedule: ONE full-shard row gather
    (local sources), then per-offset packed send/recv + scatter.  Per-shard
    HBM traffic ~ 1R+1W of the shard plus the packed rows; ICI volume ~ one
    shard total across all offsets (cf. _rotate_gather_rows: D full-shard
    ppermutes each with a full-shard gather+blend)."""
    D = 1 << d
    local_tab, schedule = _packed_exchange_schedule(C, atox, m_reg, d)
    local_me = jnp.take(jnp.asarray(local_tab), me, axis=0)  # (R,)
    outs = [jnp.take(x, local_me, axis=0) for x in planes]
    for delta, send_tab, recv_tab in schedule:
        send_me = jnp.take(jnp.asarray(send_tab), me, axis=0)
        recv_me = jnp.take(jnp.asarray(recv_tab), me, axis=0)
        bufs = tuple(jnp.take(x, send_me, axis=0) for x in planes)
        rbufs = lax.ppermute(bufs, AXIS, [(p, (p + delta) % D) for p in range(D)])
        outs = [o.at[recv_me].set(rb, mode="drop") for o, rb in zip(outs, rbufs)]
    return outs


@lru_cache(maxsize=8)
def packed_slot_routes(C: int, a: int, L: int, m_reg: int, d: int):
    """Packed routing OPERANDS for the slot (compile-once) m_high mesh
    oracle (ROADMAP r3 item 3 — the hybrid): the round structure (all D-1
    offsets, a shared padded row count K_pad) is static, while the row
    index tables are traced operands.  One program therefore serves every
    trial integer whose schedule fits the same K_pad bucket — the
    compile-once property of the slot form WITH (near-)packed traffic:
    (D-1) * K_pad shipped rows vs the rotation form's (D-1) full shards.

    K_pad is the max per-(device, offset) row count across ALL L slot
    permutations (a^(2^j) mod C, j < L), rounded up to a power of two, so
    the route-class key is just K_pad: different `a` values usually rebind
    tables into the SAME compiled program (jit re-traces only on a shape
    change).  For the near-uniform modular spread K_pad ~ R/D, giving
    ~(D-1)/D shards of total ICI volume — same as the static packed
    schedule up to the power-of-two padding.

    Returns a tuple of L per-slot entries (local_idx (D, R), send_idx
    (D, D-1, K_pad), recv_dst (D, D-1, K_pad)), conventions as in
    _packed_exchange_schedule (send padding gathers row 0; recv padding
    points at row R -> dropped by scatter mode='drop')."""
    from quantumcomputer.ops.gates import modmul_inverse_permutation

    D = 1 << d
    R = (1 << m_reg) >> d
    rows = np.arange(D * R, dtype=np.int64)
    dst_dev = rows // R

    srcs = [
        np.asarray(modmul_inverse_permutation(C, pow(a, 1 << j, C), m_reg), np.int64)
        for j in range(L)
    ]
    k_need = 1
    for src in srcs:
        delta_of = (dst_dev - src // R) % D
        for delta in range(1, D):
            hit = delta_of == delta
            k_need = max(k_need, int(np.max(np.sum(hit.reshape(D, R), axis=1), initial=0)))
    k_pad = 1 << (k_need - 1).bit_length()  # route-class bucket (<= R: R is 2^k)

    routes = []
    for src in srcs:
        delta_of = (dst_dev - src // R) % D
        local_idx = _local_source_rows(src, delta_of, D, R, rows)
        send_idx = np.zeros((D, D - 1, k_pad), np.int32)
        recv_dst = np.full((D, D - 1, k_pad), R, np.int32)
        for delta in range(1, D):
            _fill_offset_routes(
                src, delta_of, D, R, delta, send_idx[:, delta - 1], recv_dst[:, delta - 1]
            )
        routes.append((local_idx, send_idx, recv_dst))
    return tuple(routes)


def _apply_rows_packed_traced(planes, local_me, send_me, recv_me, D: int):
    """Traced-operand twin of _apply_rows_packed for SLOT oracle gates:
    `local_me` (R,), `send_me`/`recv_me` (D-1, K_pad) are this device's
    rows of a packed_slot_routes entry (traced, bound at dispatch).  The
    loop structure is static — D-1 offsets, K_pad rows each — so the
    compiled program is reused across trial integers."""
    outs = [jnp.take(x, local_me, axis=0) for x in planes]
    for delta in range(1, D):
        bufs = tuple(jnp.take(x, send_me[delta - 1], axis=0) for x in planes)
        rbufs = lax.ppermute(bufs, AXIS, [(p, (p + delta) % D) for p in range(D)])
        outs = [o.at[recv_me[delta - 1]].set(rb, mode="drop") for o, rb in zip(outs, rbufs)]
    return outs


def _rotate_gather_rows(x, srow_loc, sdev_loc, deltas, me, D: int):
    """Shared device-exchange rotation for the m_high oracle forms: for
    each offset in `deltas`, ship every device's block to device+delta and
    let receivers take the rows whose source lives in that block."""
    acc = x
    for delta in deltas:
        if delta == 0:
            incoming, src = x, me
        else:
            incoming = lax.ppermute(x, AXIS, [(p, (p + delta) % D) for p in range(D)])
            src = (me - delta) % D
        gathered = jnp.take(incoming, srow_loc, axis=0)
        mask = (sdev_loc == src)[:, None]
        acc = jnp.where(mask, gathered, acc)
    return acc


def apply_gate_sharded(z, g: Gate, *, n: int, M: int, d: int, me, tables=(), routes=()):
    """Dispatch one gate on the local shard (complex, flat 2^(n-d)).
    `tables` carries runtime permutation operands for SLOT oracle gates
    (the compile-once trial-loop form; models/shor_circuit)."""
    n_local = n - d
    D = 1 << d

    def is_global(q):
        return q >= n_local

    name = g.name
    if name in DENSE_1Q:
        u = gate_matrix_1q(g)
        q = g.qubits[0]
        if not is_global(q):
            return xops.apply_1q(z, jnp.asarray(u, z.dtype), q)
        return _apply_1q_global(z, u, q - n_local, me, D)

    if name in DIAGONAL_1Q:
        dg = np.diagonal(gate_matrix_1q(g))
        q = g.qubits[0]
        if not is_global(q):
            return xops.apply_diag_1q(z, jnp.asarray(dg, z.dtype), q)
        return _apply_diag_global_scalar(z, dg[1], dg[0], _device_bit(me, q - n_local))

    if name in ("cz", "cphase"):
        d4 = np.diagonal(gate_matrix_2q(g))
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        hi_g, lo_g = is_global(q_hi), is_global(q_lo)
        if not hi_g and not lo_g:
            return xops.apply_diag_2q(z, jnp.asarray(d4, z.dtype), q_hi, q_lo)
        if hi_g and lo_g:
            b_hi = _device_bit(me, q_hi - n_local)
            b_lo = _device_bit(me, q_lo - n_local)
            idx = 2 * b_hi + b_lo
            f = jnp.asarray(d4, z.dtype)[idx]
            return z * f
        if hi_g:
            b = _device_bit(me, q_hi - n_local)
            v = jnp.where(b == 0, jnp.asarray(d4[:2], z.dtype), jnp.asarray(d4[2:], z.dtype))
            return xops.apply_diag_1q(z, v, q_lo)
        b = _device_bit(me, q_lo - n_local)
        v0 = jnp.asarray(d4[[0, 2]], z.dtype)
        v1 = jnp.asarray(d4[[1, 3]], z.dtype)
        return xops.apply_diag_1q(z, jnp.where(b == 0, v0, v1), q_hi)

    if name == "mcphase":
        # Diagonal on every control: global bits collapse to a per-device
        # scalar condition (no communication), local bits to a masked
        # elementwise pass — same policy as the oracle's global controls.
        theta = float(g.params[0])
        mask = 0
        cond = None
        for q in g.qubits:
            if is_global(q):
                b = _device_bit(me, q - n_local) == 1
                cond = b if cond is None else (cond & b)
            else:
                mask |= 1 << q
        idx = lax.iota(jnp.int32, z.shape[0])
        hit = (idx & jnp.int32(mask)) == jnp.int32(mask)
        if cond is not None:
            hit = hit & cond
        ph = jnp.asarray(np.exp(1j * theta), z.dtype)
        return jnp.where(hit, z * ph, z)

    if name in ("cnot", "swap", "u2q"):
        m4 = gate_matrix_2q(g)
        q0, q1 = g.qubits
        # Reorder so the matrix basis is 2*bit(qa) + bit(qb) with qa the
        # qubit we treat as "first"; swap roles via the [0,2,1,3] relabel.
        def relabel(m):
            p = [0, 2, 1, 3]
            return m[np.ix_(p, p)]

        g0, g1 = is_global(q0), is_global(q1)
        if not g0 and not g1:
            q_hi, q_lo, m = (q0, q1, m4) if q0 > q1 else (q1, q0, relabel(m4))
            return xops.apply_2q(z, jnp.asarray(m, z.dtype), q_hi, q_lo)
        if g0 and g1:
            q_hi, q_lo, m = (q0, q1, m4) if q0 > q1 else (q1, q0, relabel(m4))
            return _apply_2q_both_global(z, m, q_hi - n_local, q_lo - n_local, me, D)
        if g0:  # q0 global, q1 local; basis already 2*bit(q0)+bit(q1)
            return _apply_2q_one_global(z, m4, q0 - n_local, q1, me, D)
        # q1 global, q0 local: relabel so global qubit indexes the high bit.
        return _apply_2q_one_global(z, relabel(m4), q1 - n_local, q0, me, D)

    if name in ("camodc", "camodc_slot"):
        if name == "camodc":
            C, atox = g.meta
            ginv = None
        else:  # slot form: traced table operand (compile-once trial loop)
            ginv = tables[g.meta[0]]
        c_q = g.qubits[0]
        assert M <= n_local, "M register must be shard-local"
        if not is_global(c_q):
            if ginv is None:
                return xops.apply_c_amodc(z, C, atox, c_q, M)
            return xops.apply_c_amodc_dyn(z, ginv, c_q, M)
        # Control bit is a device coordinate: permute-or-identity, no comms.
        if ginv is None:
            ginv = jnp.asarray(xops.modmul_inverse_permutation(C, atox, M))
        m_dim = 1 << M
        x = z.reshape(-1, m_dim)
        permuted = jnp.take(x, ginv, axis=-1).reshape(z.shape)
        ctrl = _device_bit(me, c_q - n_local)
        return jnp.where(ctrl == 1, permuted, z)

    if name == "camodc_high_slot":
        # m_high slot oracle on the mesh: like camodc_high below, but the
        # permutation is a TRACED operand.  With `routes` bound
        # (packed_slot_routes) the exchange uses the packed static round
        # structure with traced index tables — compile-once AND packed;
        # with tables only, the (src, dst) device schedule cannot be pruned
        # at trace time, so all D-1 rotation rounds run (the fallback).
        slot, m_reg = g.meta
        c_phys = g.qubits[0]
        assert d <= m_reg, "m_high sharding needs the global bits inside the M register"
        rest = 1 << (n - m_reg)
        R = (1 << m_reg) >> d
        x = z.reshape(R, rest)
        if routes and routes[slot] is not None:
            local_tab, send_tab, recv_tab = routes[slot]
            (acc,) = _apply_rows_packed_traced(
                (x,),
                jnp.take(local_tab, me, axis=0),
                jnp.take(send_tab, me, axis=0),
                jnp.take(recv_tab, me, axis=0),
                D,
            )
        else:
            ginv = tables[slot]
            sdev_loc = lax.dynamic_slice_in_dim(ginv // R, me * R, R)
            srow_loc = lax.dynamic_slice_in_dim(ginv % R, me * R, R)
            acc = _rotate_gather_rows(x, srow_loc, sdev_loc, range(D), me, D)
        col = lax.iota(jnp.int32, rest)
        ctrl = ((col >> c_phys) & 1) == 1
        return jnp.where(ctrl[None, :], acc, x).reshape(z.shape)

    if name == "camodc_high":
        # M-HIGH layout oracle ON THE MESH: the work register occupies the
        # top M physical bits, of which the top d are device coordinates —
        # the row permutation f -> A*f mod C becomes a DEVICE exchange
        # (ROADMAP item 4; single-chip form: ops/gates.apply_camodc_high).
        #
        # Lowering: the permutation's (src_device -> dst_device) schedule is
        # STATIC (C, A, M, D all compile-time), so each device ships each
        # partner only the rows it needs (_apply_rows_packed): one
        # full-shard row gather for local sources plus per-offset packed
        # sends — ~1R+1W of HBM and ~one shard of total ICI volume, vs the
        # D-round full-shard rotate-blend this replaces (VERDICT r2 item 2).
        # The control qubit is a low physical bit, so the final control
        # mask is shard-local.
        C, atox, m_reg = g.meta
        c_phys = g.qubits[0]
        assert d <= m_reg, "m_high sharding needs the global bits inside the M register"
        rest = 1 << (n - m_reg)  # columns (L-register span)
        R = (1 << m_reg) >> d    # work-register rows per device
        x = z.reshape(R, rest)
        (acc,) = _apply_rows_packed((x,), int(C), int(atox), m_reg, d, me)
        col = lax.iota(jnp.int32, rest)
        ctrl = ((col >> c_phys) & 1) == 1
        return jnp.where(ctrl[None, :], acc, x).reshape(z.shape)

    if name == "camodc_ladder_high":
        # A fused RUN of m_high oracles on the mesh (see engine.fuse_oracle_
        # ladders): the composed source row depends on the COLUMN's control
        # bits (all shard-local), so ONE D-round ppermute rotation replaces
        # K of them — the collective volume drops K-fold.  Row selection
        # within each incoming block is a per-element gather (the source
        # row varies per column).
        C, m_reg = g.meta[0], g.meta[1]
        A_list = g.meta[2:]
        controls = g.qubits
        assert d <= m_reg
        from quantumcomputer.ops.gates import modexp_combo_multipliers

        rest = 1 << (n - m_reg)
        R = (1 << m_reg) >> d
        combos = jnp.asarray(modexp_combo_multipliers(C, A_list), jnp.int32)
        col = lax.iota(jnp.int32, rest)
        bits = jnp.zeros_like(col)
        for k, c in enumerate(controls):
            bits = bits | (((col >> c) & 1) << k)
        mult = combos[bits]  # (rest,)
        x = z.reshape(R, rest)
        f_out = (me * R + lax.iota(jnp.int32, R))[:, None]  # global output rows
        src = jnp.where(f_out < C, (mult[None, :] * f_out) % C, f_out)  # (R, rest)
        src_dev = src // R
        src_loc = src % R
        # Statically conservative: every offset may be needed by some
        # (row, mask) pair somewhere on the mesh.
        acc = x
        for delta in range(D):
            if delta == 0:
                incoming, src_of = x, me
            else:
                incoming = lax.ppermute(x, AXIS, [(p, (p + delta) % D) for p in range(D)])
                src_of = (me - delta) % D
            gathered = jnp.take_along_axis(incoming, src_loc, axis=0)
            acc = jnp.where(src_dev == src_of, gathered, acc)
        return acc.reshape(z.shape)

    if name == "iqft_stage":
        l = g.qubits[0]
        if not is_global(l):
            return xops.apply_iqft_stage(z, l, M)
        # H on the global qubit, then the closed-form ladder diagonal
        # (see xops.iqft_stage_phases) evaluated at *global* indices.
        z = _apply_1q_global(z, _H64(), l - n_local, me, D)
        if l > M:
            ls = z.shape[0]
            mask = (1 << l) - (1 << M)
            # (global_index & mask) built from int32-safe pieces: local bits
            # from the shard iota, device bits [n_local, l) from me — the
            # full global index would overflow int32 at n = 32.
            masked = lax.iota(jnp.int32, ls) & mask
            if l > n_local:
                masked = masked + ((me & ((1 << (l - n_local)) - 1)) << n_local)
            frac = masked.astype(sv.real_dtype_of(z.dtype)) * (np.pi / float(1 << l))
            phase = lax.complex(jnp.cos(frac), jnp.sin(frac)).astype(z.dtype)
            bit_l = _device_bit(me, l - n_local)
            z = jnp.where(bit_l == 1, z * phase, z)
        return z

    raise ValueError(f"unknown gate: {g}")


def _H64() -> np.ndarray:
    s = 1.0 / np.sqrt(2.0)
    return np.array([[s, s], [s, -s]], dtype=np.complex128)


class ShardedStateVectorEngine:
    """Multi-device drop-in for StateVectorEngine (same API; planar states
    sharded over the mesh)."""

    def __init__(
        self,
        register: Register,
        dtype=jnp.complex64,
        mesh: Optional[Mesh] = None,
        layout: str = "standard",
    ):
        if layout not in ("standard", "m_high"):
            raise ValueError(f"unknown layout {layout!r}")
        self.register = register
        if isinstance(dtype, str) and dtype in (sv.COMPLEX32, "c32"):
            # bf16-STORAGE throughput mode on the mesh: bf16 planes thread
            # through shard_map (no complex dtype exists at this width), so
            # every collective moves half the bytes of the complex64 path
            # and every blend upcasts to f32 inside the expression.
            self.dtype = sv.COMPLEX32
        else:
            self.dtype = jnp.dtype(dtype)
        self.real_dtype = sv.real_dtype_of(dtype)
        self.layout = layout
        self.mesh = mesh if mesh is not None else build_mesh()
        self.d = mesh_degree(self.mesh)
        if register.n - self.d < 1:
            raise ValueError("register too small for this mesh")
        if layout == "m_high":
            # Work register in the TOP physical bits: the global (device)
            # bits live inside it; the oracle row exchange rides ICI and
            # every H/iQFT butterfly is shard-local (ROADMAP item 4).
            if self.d > register.M:
                raise ValueError(
                    f"mesh degree d={self.d} must be <= M={register.M}: "
                    "the m_high global bits must lie inside the work register"
                )
        elif register.M > register.n - self.d:
            raise ValueError(
                f"M={register.M} must be <= n_local={register.n - self.d}: "
                "the work register must stay shard-local"
            )
        # m_high: L register in physical low bits, iQFT ladder boundary at 0,
        # reset |0..01> at physical index 2^L (logical M-register value 1).
        self.m_eff = 0 if layout == "m_high" else register.M
        self.reset_index = (1 << register.L) if layout == "m_high" else 1
        self.sharding = state_sharding(self.mesh)
        self._run_cache: dict = {}

    def logical_index(self, phys: int) -> int:
        """Measured physical basis index -> logical (reference convention)."""
        if self.layout == "standard":
            return phys
        L, M = self.register.L, self.register.M
        return (phys >> L) | ((phys & ((1 << L) - 1)) << M)

    def _global_index(self, dev: int, loc: int) -> int:
        """Compose a measured (device, local) pair into the global physical
        index ON THE HOST: Python ints are arbitrary-precision, so this is
        exact at any n, whereas an in-program int32 global index would wrap
        at n = 32 (the reference documents its own 32-qubit index bound,
        qc_shor.c:68-73; see tests/test_index_width.py)."""
        return (dev << (self.register.n - self.d)) | loc

    # -- state lifecycle ----------------------------------------------------

    def _basis_state(self, index: int) -> jax.Array:
        """|index> as a sharded planar state, built shard by shard from
        (device, local) int32 indices — exact at n = 32, where a global
        int32 index would wrap."""
        ls = (1 << self.register.n) >> self.d
        dev, loc, rdtype = index // ls, index % ls, self.real_dtype

        def body():
            return _collapse_planes(dev, loc, lax.axis_index(AXIS), ls, rdtype)

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh, in_specs=(), out_specs=P(None, AXIS), check_vma=False
        ))()

    def initial_state(self) -> jax.Array:
        return self._basis_state(self.reset_index)

    def zero_state(self) -> jax.Array:
        return self._basis_state(0)

    # -- execution ----------------------------------------------------------

    def _compiled_run(self, circuit: Circuit) -> Callable:
        fn = self._run_cache.get(circuit)
        if fn is None:
            n, M, d = self.register.n, self.m_eff, self.d
            from quantumcomputer.models.circuit import dagger_circuit

            adj = dagger_circuit(circuit, M)
            bf16 = self.real_dtype == jnp.bfloat16

            def _body_of(circ):
                def body(planar):  # local view: (2, 2^(n-d))
                    me = lax.axis_index(AXIS)
                    if bf16:
                        re, im = apply_circuit_sharded_planes(
                            planar[0], planar[1], circ, n=n, M=M, d=d, me=me
                        )
                        return jnp.stack([re, im])
                    z = sv.to_complex(planar)
                    z = apply_circuit_sharded(z, circ, n=n, M=M, d=d, me=me)
                    return sv.from_complex(z)

                return jax.shard_map(
                    body, mesh=self.mesh, in_specs=(P(None, AXIS),), out_specs=P(None, AXIS),
                )

            run_impl = _body_of(circuit)
            adj_impl = _body_of(adj)

            # Exact O(1)-memory adjoint backprop, like the single-chip
            # engine: the cotangent transforms by U^dagger across the mesh.
            run = jax.custom_vjp(run_impl)
            run.defvjp(lambda p: (run_impl(p), None), lambda _, ct: (adj_impl(ct),))

            fn = jax.jit(run, donate_argnums=(0,))
            self._run_cache[circuit] = fn
        return fn

    def run(self, circuit: Circuit, state: Optional[jax.Array] = None) -> jax.Array:
        if state is None:
            state = self.initial_state()
        return self._compiled_run(circuit)(state)

    def run_with_norms(self, circuit: Circuit, state: Optional[jax.Array] = None):
        """Post-step norm trace across the mesh (Report §IV.A / FIG. 2 at
        scale), on the production path: one norm per gate; local |amp|^2
        sums psum-reduced."""
        if state is None:
            state = self.initial_state()
        key = (circuit, "__norms__")
        fn = self._run_cache.get(key)
        if fn is None:
            n, M, d = self.register.n, self.m_eff, self.d

            bf16 = self.real_dtype == jnp.bfloat16

            def body(planar):
                me = lax.axis_index(AXIS)
                if bf16:
                    (re, im), norms = apply_circuit_sharded_planes(
                        planar[0], planar[1], circuit, n=n, M=M, d=d, me=me,
                        trace_norms=True,
                    )
                    return jnp.stack([re, im]), (
                        jnp.stack(norms) if norms else jnp.zeros((0,), jnp.float32)
                    )
                z, norms = apply_circuit_sharded(
                    sv.to_complex(planar), circuit, n=n, M=M, d=d, me=me,
                    trace_norms=True,
                )
                return sv.from_complex(z), (
                    jnp.stack(norms) if norms else jnp.zeros((0,), planar.dtype)
                )

            smapped = jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P(None, AXIS),),
                out_specs=(P(None, AXIS), P()),
                check_vma=False,
            )
            fn = jax.jit(smapped, donate_argnums=(0,))
            self._run_cache[key] = fn
        return fn(state)

    # -- measurement ----------------------------------------------------------

    def _measure_fn(self):
        def body(planar, key):
            return _measure_local(planar, key)

        smapped = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(None, AXIS), P()),
            out_specs=(P(), P(), P(None, AXIS)),
            check_vma=False,
        )
        return jax.jit(smapped, donate_argnums=(0,))

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> psum'd norm, as ONE compiled shard_map
        program whose only output is the scalar norm — no state-sized
        buffer crosses the program boundary (the memory-ceiling-safe form;
        mirrors StateVectorEngine.run_norm across the mesh)."""
        ck = (circuit, "__run_norm__")
        fn = self._run_cache.get(ck)
        if fn is None:
            n, M, d = self.register.n, self.m_eff, self.d
            rdtype = self.real_dtype
            D = 1 << d
            ls = (1 << n) // D
            r0 = self.reset_index

            def body():
                me = lax.axis_index(AXIS)
                # |0..01> reset via int32-safe (device, local) split compare.
                r0_dev, r0_loc = r0 // ls, r0 % ls
                onehot = ((me == r0_dev) & (lax.iota(jnp.int32, ls) == r0_loc)).astype(rdtype)
                if rdtype == jnp.bfloat16:
                    re, im = apply_circuit_sharded_planes(
                        onehot, jnp.zeros_like(onehot), circuit,
                        n=n, M=M, d=d, me=me,
                    )
                    acc = jnp.float32
                    return lax.psum(jnp.sum(re.astype(acc) ** 2) + jnp.sum(im.astype(acc) ** 2), AXIS)
                z = lax.complex(onehot, jnp.zeros_like(onehot))
                z = apply_circuit_sharded(z, circuit, n=n, M=M, d=d, me=me)
                return lax.psum(jnp.sum(jnp.real(z) ** 2 + jnp.imag(z) ** 2), AXIS)

            smapped = jax.shard_map(
                body, mesh=self.mesh, in_specs=(), out_specs=P(), check_vma=False
            )
            fn = jax.jit(smapped)
            self._run_cache[ck] = fn
        return float(fn())

    def run_and_measure_index(self, circuit: Circuit, key: jax.Array) -> int:
        """Reset -> circuit -> measured global index, as ONE compiled
        shard_map program with a SCALAR output: the collapsed state is dead
        code, so the program holds one sharded state only (the form that
        scales to the per-chip memory ceiling)."""
        # Shares the tables-form builder with an empty operand tuple (no
        # leaves reach the jaxpr -> identical compiled program).
        return self.run_and_measure_index_with_tables(circuit, (), key)

    def run_and_measure_index_with_tables(
        self, circuit: Circuit, tables, key: jax.Array, routes=None
    ) -> int:
        """run_and_measure_index for TEMPLATE circuits with SLOT oracle
        gates: the permutation tables are replicated program OPERANDS, so
        ONE shard_map program serves every trial integer (the mesh form of
        the compile-once trial loop; see StateVectorEngine).

        `routes` (optional, packed_slot_routes output) binds packed m_high
        exchange operands: the program keeps the packed ~(D-1)/D-shard ICI
        volume of the static oracle while remaining reusable across every
        trial integer in the same K_pad route-class (the padded row-count
        bucket is the only shape the program depends on)."""
        routes = tuple(routes) if routes else ()
        # Route shapes are part of the program: K_pad (the route-class
        # bucket) changes operand shapes, so it keys the cache alongside
        # the slot count.
        rshape = tuple(
            None if r is None else tuple(np.asarray(t).shape for t in r) for r in routes
        )
        ck = (circuit, "__run_measure_idx_dyn__", len(tables), rshape)
        fn = self._run_cache.get(ck)
        if fn is None:
            n, M, d = self.register.n, self.m_eff, self.d
            rdtype = self.real_dtype
            D = 1 << d
            ls = (1 << n) // D
            r0 = self.reset_index

            def body(tabs, rts, k):
                me = lax.axis_index(AXIS)
                # |0..01> reset via int32-safe (device, local) split compare.
                r0_dev, r0_loc = r0 // ls, r0 % ls
                onehot = ((me == r0_dev) & (lax.iota(jnp.int32, ls) == r0_loc)).astype(rdtype)
                if rdtype == jnp.bfloat16:
                    re, im = apply_circuit_sharded_planes(
                        onehot, jnp.zeros_like(onehot), circuit,
                        n=n, M=M, d=d, me=me, tables=tabs, routes=rts,
                    )
                else:
                    z = apply_circuit_sharded(
                        lax.complex(onehot, jnp.zeros_like(onehot)), circuit,
                        n=n, M=M, d=d, me=me, tables=tabs, routes=rts,
                    )
                    # Measure from the re/im planes directly — never a
                    # stacked (2, ls) copy while the state is live (the
                    # program truly holds ONE sharded state).
                    re, im = jnp.real(z), jnp.imag(z)
                return _measure_index_planes(re, im, k)

            smapped = jax.shard_map(
                body, mesh=self.mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()), check_vma=False
            )
            fn = jax.jit(smapped)
            self._run_cache[ck] = fn
        tabs = tuple(jnp.asarray(np.asarray(t), jnp.int32) for t in tables)
        rts = tuple(
            None if r is None else tuple(jnp.asarray(np.asarray(t), jnp.int32) for t in r)
            for r in routes
        )
        dev, loc = fn(tabs, rts, key)
        return self._global_index(int(dev), int(loc))

    def run_and_measure(self, circuit: Circuit, key: jax.Array) -> Tuple[int, jax.Array]:
        """Reset -> circuit -> sharded measurement, as ONE compiled shard_map
        program.  Returns (measured global index, collapsed planar state)."""
        ck = (circuit, "__run_measure__")
        fn = self._run_cache.get(ck)
        if fn is None:
            n, M, d = self.register.n, self.m_eff, self.d
            rdtype = self.real_dtype
            D = 1 << d
            ls = (1 << n) // D
            r0 = self.reset_index

            def body(k):
                me = lax.axis_index(AXIS)
                # |0..01> reset, shard-local construction (layout-aware index),
                # int32-safe (device, local) split compare.
                r0_dev, r0_loc = r0 // ls, r0 % ls
                onehot = ((me == r0_dev) & (lax.iota(jnp.int32, ls) == r0_loc)).astype(rdtype)
                if rdtype == jnp.bfloat16:
                    re, im = apply_circuit_sharded_planes(
                        onehot, jnp.zeros_like(onehot), circuit,
                        n=n, M=M, d=d, me=me,
                    )
                else:
                    z = apply_circuit_sharded(
                        lax.complex(onehot, jnp.zeros_like(onehot)), circuit,
                        n=n, M=M, d=d, me=me,
                    )
                    re, im = jnp.real(z), jnp.imag(z)
                dev, loc = _measure_index_planes(re, im, k)
                return dev, loc, _collapse_planes(dev, loc, me, ls, rdtype)

            smapped = jax.shard_map(
                body, mesh=self.mesh, in_specs=(P(),), out_specs=(P(), P(), P(None, AXIS)),
                check_vma=False,
            )
            fn = jax.jit(smapped)
            self._run_cache[ck] = fn
        dev, loc, collapsed = fn(key)
        return self._global_index(int(dev), int(loc)), collapsed

    def measure(self, state: jax.Array, key: jax.Array) -> Tuple[int, jax.Array]:
        fn = self._run_cache.get("__measure__")
        if fn is None:
            fn = self._measure_fn()
            self._run_cache["__measure__"] = fn
        dev, loc, collapsed = fn(state, key)
        return self._global_index(int(dev), int(loc)), collapsed

    def sample(self, state: jax.Array, key: jax.Array, shots: int) -> jax.Array:
        """Draw `shots` independent basis indices from |amp|^2 WITHOUT
        collapsing, across the mesh: per-shard totals are all_gathered for
        the device-level pick, then each shot scans only its own shard
        (same two-level inverse-CDF as measure())."""
        fn = self._run_cache.get(("__sample__", shots))
        if fn is None:
            rdtype = self.real_dtype

            def body(planar, k):
                probs = sv.probabilities(planar)  # f32-accumulated for bf16
                rs = jax.random.uniform(k, (shots,), dtype=_acc_dtype(rdtype))  # same on all shards
                # The shared pick handles the (shots,) vector draw; scaling
                # by the global total normalizes bf16 probability drift.
                # (device, local) int32 pairs compose on the host —
                # int32-safe at any n.
                return two_level_pick(probs, rs, scale_by_total=True)

            smapped = jax.shard_map(
                body, mesh=self.mesh, in_specs=(P(None, AXIS), P()), out_specs=(P(), P()),
                check_vma=False,
            )
            fn = jax.jit(smapped)
            self._run_cache[("__sample__", shots)] = fn
        dev, loc = fn(state, key)
        ls = (1 << self.register.n) >> self.d
        return np.asarray(dev, np.int64) * ls + np.asarray(loc, np.int64)

    # -- inspection ----------------------------------------------------------

    def probabilities(self, state: jax.Array) -> jax.Array:
        return sv.probabilities(state)

    def norm(self, state: jax.Array) -> float:
        return float(sv.norm(state))

    def to_numpy(self, state: jax.Array):
        return sv.to_numpy_complex(state)
