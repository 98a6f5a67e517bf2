"""XLA-path gate ops on a flat 2^n complex state vector.

The reference builds an explicit 2^N x 2^N sparse matrix for every gate and
multiplies it (qc_shor.c:370-690, O(4^N) build + O(2^N) apply).  Here each
gate is a reshape + contraction / elementwise-multiply / gather directly on
the amplitude tensor — O(2^N), one HBM pass, fully fusable by XLA:

  * 1-qubit unitary  -> (outer, 2, inner) einsum against the target axis
    (replaces hadamard_gate, qc_shor.c:442-484);
  * controlled phase -> diagonal: a (2, 2) factor broadcast over the
    (.., 2, .., 2, ..) exposed control/target axes — no index iota, no
    matrix (replaces c_phase_shift_gate, qc_shor.c:513-565);
  * the whole controlled-phase ladder of one inverse-QFT stage collapses to
    a single closed-form diagonal exp(i*pi*(i & mask)/2^l) on the inner
    index (replaces the L(L-1)/2 separate matrices of qc_shor.c:678-690);
  * controlled modular multiplication -> permutation gather over the
    M-register axis (replaces c_amodc_gate, qc_shor.c:595-660);
  * measurement -> |amp|^2 cumsum + searchsorted, the vectorized form of
    the reference's serial inverse-CDF scan (qc_shor.c:272-306).

All functions are pure and jittable; qubit indices and register sizes are
Python ints (static under jit).  Conventions: qubit b == bit b of the flat
index, LSB-first; M register = bits [0, M).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

SQRT1_2 = 1.0 / math.sqrt(2.0)


def hadamard(dtype=jnp.complex64) -> jax.Array:
    return jnp.array([[SQRT1_2, SQRT1_2], [SQRT1_2, -SQRT1_2]], dtype=dtype)


def num_qubits_of(state: jax.Array) -> int:
    n = int(state.shape[-1]).bit_length() - 1
    assert state.shape[-1] == 1 << n, "state length must be a power of 2"
    return n


def initial_state(n: int, dtype=jnp.complex64) -> jax.Array:
    """|00...01>: amplitude 1 at index 1 (qc_shor.c:318-324)."""
    return jnp.zeros(1 << n, dtype=dtype).at[1].set(1.0)


# Below this size the einsum formulation is used verbatim; above it, the
# slice/roll forms keep every materialized view's minor dimension >= 128
# (no (.., 2, small) reshape is materialized for a contraction).
_SMALL_DIM = 1 << 13


def _apply_1q_einsum(state: jax.Array, u2: jax.Array, q: int) -> jax.Array:
    dim = state.shape[0]
    inner = 1 << q
    x = state.reshape(dim // (2 * inner), 2, inner)
    y = jnp.einsum("ab,obi->oai", u2.astype(state.dtype), x, precision=jax.lax.Precision.HIGHEST)
    return y.reshape(dim)


def _apply_1q_wide(state: jax.Array, u2: jax.Array, q: int) -> jax.Array:
    """q >= 6: view (rows, 2^(q+1)); both butterfly halves are contiguous
    halves of the last axis — static slices + concat, minor dim >= 128."""
    dim = state.shape[0]
    s = 1 << q
    u2 = u2.astype(state.dtype)
    x = state.reshape(dim // (2 * s), 2 * s)
    a, b = x[:, :s], x[:, s:]
    y = jnp.concatenate([u2[0, 0] * a + u2[0, 1] * b, u2[1, 0] * a + u2[1, 1] * b], axis=1)
    return y.reshape(dim)


def _apply_1q_roll(state: jax.Array, u2: jax.Array, q: int) -> jax.Array:
    """q < 6: view (rows, 128); the partner lives in the same 128-lane row at
    offset ±2^q (setting bit q never carries), so a lane roll + bit select
    implements the butterfly with no sub-128 minor dims."""
    dim = state.shape[0]
    s = 1 << q
    u2 = u2.astype(state.dtype)
    x = state.reshape(dim // 128, 128)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    bit1 = ((lane >> q) & 1) == 1
    partner = jnp.where(bit1, jnp.roll(x, s, axis=1), jnp.roll(x, -s, axis=1))
    diag = jnp.where(bit1, u2[1, 1], u2[0, 0])
    off = jnp.where(bit1, u2[1, 0], u2[0, 1])
    return (diag * x + off * partner).reshape(dim)


def apply_1q(state: jax.Array, u2: jax.Array, q: int) -> jax.Array:
    """Apply a 2x2 unitary to qubit q of the flat state."""
    dim = state.shape[0]
    if dim < _SMALL_DIM:
        return _apply_1q_einsum(state, u2, q)
    if q >= 6:
        return _apply_1q_wide(state, u2, q)
    return _apply_1q_roll(state, u2, q)


def apply_hadamard(state: jax.Array, q: int) -> jax.Array:
    return apply_1q(state, hadamard(state.dtype), q)


def _xor_shift(x: jax.Array, q: int) -> jax.Array:
    """x[p ^ 2^q] for every p: two circular rolls + a bit select.  Setting
    or clearing bit q never carries past the array end, so the wrapped
    positions are never selected."""
    s = 1 << q
    bit1 = ((jax.lax.iota(jnp.int32, x.shape[0]) >> q) & 1) == 1
    return jnp.where(bit1, jnp.roll(x, s), jnp.roll(x, -s))


def _bit_mask(dim: int, q: int) -> jax.Array:
    return (jax.lax.iota(jnp.int32, dim) >> q) & 1


def _apply_2q_einsum(state: jax.Array, u4: jax.Array, q_hi: int, q_lo: int) -> jax.Array:
    dim = state.shape[0]
    c = 1 << q_lo
    b = 1 << (q_hi - q_lo - 1)
    a = dim // (4 * b * c)
    x = state.reshape(a, 2, b, 2, c)
    u = u4.astype(state.dtype).reshape(2, 2, 2, 2)
    y = jnp.einsum("efab,xaybc->xeyfc", u, x, precision=jax.lax.Precision.HIGHEST)
    return y.reshape(dim)


def _apply_2q_roll(state: jax.Array, u4: jax.Array, q_hi: int, q_lo: int) -> jax.Array:
    """Layout-safe general 2q apply for large states: gather the three XOR
    partners with circular rolls and combine with coefficients selected by
    this position's (hi, lo) bits.  Pure elementwise — no dot, so nothing
    materializes with a small minor dim."""
    dim = state.shape[0]
    u = u4.astype(state.dtype)
    xl = _xor_shift(state, q_lo)
    xh = _xor_shift(state, q_hi)
    xhl = _xor_shift(xl, q_hi)
    bh = _bit_mask(dim, q_hi)
    bl = _bit_mask(dim, q_lo)
    row = 2 * bh + bl  # this position's output row of the 4x4

    def coef(delta: int) -> jax.Array:
        """u[row, row ^ delta] as an elementwise array (delta static)."""
        vals = [u[r, r ^ delta] for r in range(4)]
        return jnp.where(
            row == 0, vals[0], jnp.where(row == 1, vals[1], jnp.where(row == 2, vals[2], vals[3]))
        )

    return coef(0) * state + coef(1) * xl + coef(2) * xh + coef(3) * xhl


def apply_2q(state: jax.Array, u4: jax.Array, q_hi: int, q_lo: int) -> jax.Array:
    """Apply a 4x4 unitary on qubits (q_hi, q_lo), q_hi > q_lo; basis index
    of the 4x4 is 2*bit(q_hi) + bit(q_lo), matching the reference's
    (2*control + target) convention (qc_shor.c:549-551)."""
    assert q_hi > q_lo, "q_hi must be the more significant qubit"
    if state.shape[0] < _SMALL_DIM:
        return _apply_2q_einsum(state, u4, q_hi, q_lo)
    return _apply_2q_roll(state, u4, q_hi, q_lo)


def apply_diag_2q(state: jax.Array, diag4: jax.Array, q_hi: int, q_lo: int) -> jax.Array:
    """Apply a diagonal 4-vector over qubits (q_hi, q_lo) — one fused
    elementwise pass (used for controlled-phase, CZ, etc.)."""
    assert q_hi > q_lo
    dim = state.shape[0]
    c = 1 << q_lo
    b = 1 << (q_hi - q_lo - 1)
    a = dim // (4 * b * c)
    x = state.reshape(a, 2, b, 2, c)
    f = diag4.astype(state.dtype).reshape(2, 2)
    return (x * f[None, :, None, :, None]).reshape(dim)


def apply_c_phase(state: jax.Array, c_q: int, t_q: int, theta: float) -> jax.Array:
    """Controlled phase shift: e^{i theta} where both bits are 1 (diagonal)."""
    q_hi, q_lo = (c_q, t_q) if c_q > t_q else (t_q, c_q)
    diag = jnp.array([1.0, 1.0, 1.0, np.exp(1j * theta)], dtype=state.dtype)
    return apply_diag_2q(state, diag, q_hi, q_lo)


def apply_mcphase(state: jax.Array, controls, theta: float) -> jax.Array:
    """Multi-controlled phase: multiply by e^{i theta} where every control
    bit is 1 (MCZ at theta = pi).  Diagonal on any control count — one
    masked elementwise pass over the state; no matrix ever exists (vs the
    reference's dense per-gate builds, qc_shor.c:513-565).  int32 indexing
    is safe through the single-chip ceiling: iota values reach dim-1 =
    2^31 - 1 at n = 31."""
    dim = state.shape[0]
    mask = 0
    for q in controls:
        mask |= 1 << int(q)
    idx = lax.iota(jnp.int32, dim)
    hit = (idx & jnp.int32(mask)) == jnp.int32(mask)
    ph = jnp.asarray(np.exp(1j * float(theta)), state.dtype)
    return jnp.where(hit, state * ph, state)


def apply_diag_1q(state: jax.Array, diag2: jax.Array, q: int) -> jax.Array:
    """Apply a diagonal 2-vector on qubit q (phase/S/T/Z gates)."""
    dim = state.shape[0]
    inner = 1 << q
    x = state.reshape(dim // (2 * inner), 2, inner)
    return (x * diag2.astype(state.dtype)[None, :, None]).reshape(dim)


def iqft_stage_phases(l: int, M: int, dtype=jnp.complex64) -> jax.Array:
    """Closed-form fused diagonal for one inverse-QFT stage.

    The stage-l controlled-phase ladder prod_{k=M}^{l-1} CP(l, k, pi/2^(l-k))
    (qc_shor.c:682-688) is diagonal with phase, on states where bit l == 1,

        theta(i) = pi * sum_k bit_k(i) / 2^(l-k) = pi * (i & mask) / 2^l,
        mask = 2^l - 2^M,

    depending only on the inner index i = index mod 2^l.  Returns the
    (2^l,)-vector of e^{i theta(i)}.
    """
    inner = 1 << l
    mask = (1 << l) - (1 << M)
    i = np.arange(inner, dtype=np.int64)
    theta = np.pi * (i & mask).astype(np.float64) / float(inner)
    return jnp.asarray(np.exp(1j * theta), dtype=dtype)


def apply_iqft_stage(state: jax.Array, l: int, M: int) -> jax.Array:
    """One fused inverse-QFT stage: H(l) then the full phase ladder as a
    single diagonal — 2 fused passes instead of the reference's 1 + (l-M)
    full matrix builds.  For large states the butterfly is the wide
    slice/concat form and the ladder phases are computed in-graph (no
    host-side 2^l constant baked in)."""
    dim = state.shape[0]
    if dim < _SMALL_DIM:
        inner = 1 << l
        x = state.reshape(dim // (2 * inner), 2, inner)
        y = jnp.einsum("ab,obi->oai", hadamard(state.dtype), x, precision=jax.lax.Precision.HIGHEST)
        if l > M:
            ph = iqft_stage_phases(l, M, state.dtype)
            factor = jnp.stack([jnp.ones_like(ph), ph])  # (2, inner): bit l selects
            y = y * factor[None, :, :]
        return y.reshape(dim)
    s = 1 << l
    x = state.reshape(dim // (2 * s), 2 * s)
    a, b = x[:, :s], x[:, s:]
    c = jnp.asarray(SQRT1_2, state.dtype)
    hu = c * (a + b)
    hv = c * (a - b)
    if l > M:
        mask = (1 << l) - (1 << M)
        rdt = jnp.float64 if state.dtype == jnp.complex128 else jnp.float32
        i = jax.lax.iota(jnp.int32, s)
        theta = (i & mask).astype(rdt) * (math.pi / float(s))
        pv = jax.lax.complex(jnp.cos(theta), jnp.sin(theta)).astype(state.dtype)
        hv = hv * pv[None, :]
    return jnp.concatenate([hu, hv], axis=1).reshape(dim)


def apply_inverse_qft(state: jax.Array, L: int, M: int) -> jax.Array:
    """Inverse QFT on the L register (qc_shor.c:678-690), stage-fused."""
    for l in range(L + M - 1, M - 1, -1):
        state = apply_iqft_stage(state, l, M)
    return state


def modmul_inverse_permutation(C: int, A: int, M: int) -> np.ndarray:
    """Gather indices for the controlled modular-multiply: output position j
    takes its amplitude from g^{-1}(j), where g: f -> A*f mod C (f < C),
    identity (f >= C).  Requires gcd(A, C) == 1 so g is a permutation, and
    2^M >= C so the permutation closes within the register (the reference
    merely warns and then silently wraps indices when 2^M < C,
    qc_shor.c:340-351 + 654; we refuse, since the gate would not be unitary)."""
    A = A % C
    if math.gcd(A, C) != 1:
        raise ValueError(f"A={A} not coprime to C={C}: gate is not a permutation")
    if (1 << M) < C:
        raise ValueError(f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)")
    a_inv = pow(A, -1, C)
    # int64 products: a_inv*f reaches ~C^2 (> int32 once C > ~46341 — the
    # semiclassical large-modulus regime); results are < 2^M so the final
    # table narrows back to int32 losslessly.
    f = np.arange(1 << M, dtype=np.int64)
    return np.where(f < C, (np.int64(a_inv) * f) % C, f).astype(np.int32)


def apply_c_amodc_dyn(state: jax.Array, ginv: jax.Array, c_q: int, M: int) -> jax.Array:
    """apply_c_amodc with the permutation table as a TRACED operand: one
    compiled program serves every (C, a) — the trial loop's compile-once
    form (see models/shor_circuit.shor_circuit_template)."""
    assert c_q >= M, "control qubit must be outside the M register"
    dim = state.shape[0]
    m_dim = 1 << M
    mid = 1 << (c_q - M)
    outer = dim // (2 * mid * m_dim)
    x = state.reshape(outer, 2, mid, m_dim)
    x1 = jnp.take(x[:, 1], ginv, axis=-1)
    return jnp.stack([x[:, 0], x1], axis=1).reshape(dim)


def modmul_onchip(a: jax.Array, j: jax.Array, C: jax.Array, nbits: int) -> jax.Array:
    """Elementwise (a * j) mod C for j < C in pure int32 — the shift-add
    (Russian peasant) modular multiply.

    Without x64 there is no int64 (and f32 mantissas cap exact products
    at 2^24), so the product is accumulated over a's bits: the invariants acc, t < C
    keep every intermediate below 2C <= 2^31 for any C < 2^30.  The nbits
    static iterations are an unrolled elementwise DAG — XLA fuses the
    whole chain into a single pass over the operand vector.  nbits must
    cover a's bit length (a < C <= 2^nbits suffices)."""
    C = jnp.asarray(C, jnp.int32)
    a = jnp.asarray(a, jnp.int32)
    t = jnp.asarray(j, jnp.int32)        # t_k = (2^k * j) mod C
    acc = jnp.zeros_like(t)
    for k in range(nbits):
        bit = (a >> k) & 1
        acc_p = acc + t
        acc_p = jnp.where(acc_p >= C, acc_p - C, acc_p)
        acc = jnp.where(bit == 1, acc_p, acc)
        t2 = t + t
        t = jnp.where(t2 >= C, t2 - C, t2)
    return acc


def modmul_permute_onchip(a: jax.Array, j: jax.Array, C: jax.Array, nbits: int) -> jax.Array:
    """The modular-multiply PERMUTATION g(j) = (a * j) mod C for j < C,
    identity for j >= C, elementwise on an arbitrary int32 index array —
    the on-device form of the oracle's index map (same semantics as
    modmul_inverse_permutation's table, qc_shor.c:595-660 index walk)."""
    lt = j < jnp.asarray(C, jnp.int32)
    return jnp.where(lt, modmul_onchip(a, jnp.where(lt, j, 0), C, nbits), j)


def modmul_inverse_indices_onchip(C: jax.Array, a_inv: jax.Array, M: int) -> jax.Array:
    """The modmul_inverse_permutation table computed ON DEVICE from two
    scalar operands — no 2^M-entry host table is ever built or uploaded.

    This is the compile-once form for LARGE moduli (semiclassical mode,
    where the per-step tables would otherwise dominate host->device
    traffic): one program serves every (C, a) with the same M.  The
    shift-add arithmetic lives in modmul_onchip (invariants documented
    there); index generation costs ~one stream of the 2^M vector per
    oracle apply."""
    return modmul_permute_onchip(a_inv, lax.iota(jnp.int32, 1 << M), C, M)


def apply_c_amodc(state: jax.Array, C: int, atox: int, c_q: int, M: int) -> jax.Array:
    """Controlled a^x mod C gate (qc_shor.c:595-660) as a blockwise gather.

    Where control bit c_q == 1, the M register is permuted by f -> A*f mod C;
    realized as new[.., 1, .., j] = old[.., 1, .., ginv(j)] — a gather over
    the last (M-register) axis, batched over everything else.  The control
    qubit must lie in the L register (c_q >= M), as in the Shor circuit.
    """
    ginv = jnp.asarray(modmul_inverse_permutation(C, atox, M))
    return apply_c_amodc_dyn(state, ginv, c_q, M)


def apply_permutation(state: jax.Array, perm_inv: jax.Array) -> jax.Array:
    """Generic full-register permutation gate: new[j] = old[perm_inv[j]]."""
    return jnp.take(state, perm_inv, axis=0)


def apply_c_amodc_strict(state: jax.Array, C: int, atox: int, c_q: int, M: int) -> jax.Array:
    """Reference BUG-COMPATIBILITY oracle (opt-in; see
    StateVectorEngine(strict_reference=True)): the scatter-add realization
    of the reference's matrix construction (qc_shor.c:595-660), which
    merely warns and keeps going when 2^M < C — the f' = A*f mod C image
    then spills past the M register and collides (index wrap at
    qc_shor.c:654), making the gate NON-UNITARY.  Matches the CPU oracle
    sim/reference.apply_c_amodc bit for bit, enabling TABLE-I-style
    side-by-side runs against the original binary even in its pathological
    configs.  The default engine refuses this case instead
    (modmul_inverse_permutation)."""
    from quantumcomputer.sim.reference import modmul_permutation

    dim = state.shape[0]
    g = jnp.asarray(modmul_permutation(C, atox % C, M), jnp.int32)
    k = jnp.arange(dim, dtype=jnp.int32)
    ctrl = (k >> c_q) & 1
    m_mask = (1 << M) - 1
    j = jnp.where(ctrl == 1, (k & ~m_mask) | g[k & m_mask], k)
    return jnp.zeros_like(state).at[j].add(state)


def apply_camodc_high(state: jax.Array, C: int, atox: int, c_phys: int, M: int) -> jax.Array:
    """Controlled a^x mod C gate in the M-HIGH layout (work register in the
    top M bits of the physical index; see models/shor_circuit.py).

    The M-register permutation becomes a gather over the MAJOR axis of the
    (2^M, 2^(n-M)) view — whole contiguous rows — instead of the
    minor-axis gather of apply_c_amodc.  The control
    qubit c_phys lives in the low bits: a per-column mask selects between
    the permuted and original rows.
    """
    ginv = jnp.asarray(modmul_inverse_permutation(C, atox, M))
    return apply_camodc_high_dyn(state, ginv, c_phys, M)


def apply_camodc_high_dyn(state: jax.Array, ginv: jax.Array, c_phys: int, M: int) -> jax.Array:
    """apply_camodc_high with the permutation table as a TRACED operand
    (the trial loop's compile-once form)."""
    dim = state.shape[0]
    rest = dim >> M
    assert (1 << c_phys) < rest, "control must be a low (non-M) bit"
    # Full-row gather + control mask.
    x = state.reshape(1 << M, rest)
    gathered = jnp.take(x, ginv, axis=0)
    col = jax.lax.iota(jnp.int32, rest)
    ctrl = ((col >> c_phys) & 1) == 1
    return jnp.where(ctrl[None, :], gathered, x).reshape(dim)


def modexp_combo_multipliers(C: int, A_list) -> np.ndarray:
    """combo[mask] = prod_k (A_k^{-1})^{bit_k(mask)} mod C.

    The controlled modular-multiply gates all multiply the work register by
    constants mod C, so THEY COMMUTE: a run of K such gates composes into a
    single permutation whose multiplier depends only on the K control bits.
    combo enumerates all 2^K composed inverse multipliers (computed by the
    native C++ layer when available; Python fallback below)."""
    from quantumcomputer.algorithms import _native

    if _native.available():
        out = _native.combo_multipliers(int(C), [int(A) % C for A in A_list])
        if out is None:
            raise ValueError(f"some multiplier not coprime to C={C}: not a permutation")
        return out.astype(np.int64)
    K = len(A_list)
    ainvs = [pow(int(A) % C, -1, C) for A in A_list]
    combos = np.ones(1 << K, np.int64)
    for mask in range(1, 1 << K):
        low = mask & -mask
        combos[mask] = (combos[mask ^ low] * ainvs[low.bit_length() - 1]) % C
    return combos


def _ladder_src_rows(C: int, A_list, controls, col_index, m_index, M: int):
    """Composed source work-register value: (combo(ctrl bits) * f) mod C for
    f < C, identity otherwise.  col_index: int32 array of the non-M index
    bits; m_index: int32 (column) array of work-register values."""
    if C * C >= (1 << 31):
        raise ValueError(f"C={C} too large for int32 ladder composition")
    if (1 << M) < C:
        raise ValueError(
            f"2^M={1 << M} < C={C}: the modular-multiply gate is not unitary (increase M)"
        )
    combos = jnp.asarray(modexp_combo_multipliers(C, A_list), jnp.int32)
    bits = jnp.zeros_like(col_index)
    for k, c in enumerate(controls):
        bits = bits | (((col_index >> c) & 1) << k)
    mult = combos[bits]
    src = (mult * m_index) % C  # broadcasts (.., rest) x (rows, ..)
    return jnp.where(m_index < C, src, jnp.broadcast_to(m_index, src.shape))


def apply_camodc_ladder_high(state: jax.Array, C: int, A_list, controls, M: int) -> jax.Array:
    """A RUN of controlled modular multiplies as ONE pass, M-HIGH layout.

    Replaces len(A_list) sequential c_amodc applications (qc_shor.c:728-731
    applies them back to back): out[f, col] = in[(combo * f) mod C, col]
    where combo is the composed inverse multiplier selected by the control
    bits of `col` (controls[k] = physical low-bit of gate k).  One full-state
    gather instead of K — the dominant flagship-circuit cost collapses by K.
    """
    dim = state.shape[0]
    rows = 1 << M
    rest = dim >> M
    col = lax.iota(jnp.int32, rest)
    f = jnp.arange(rows, dtype=jnp.int32)[:, None]
    src = _ladder_src_rows(C, A_list, controls, col[None, :], f, M)  # (rows, rest)
    x = state.reshape(rows, rest)
    return jnp.take_along_axis(x, src, axis=0).reshape(dim)


def apply_camodc_ladder(state: jax.Array, C: int, A_list, controls, M: int) -> jax.Array:
    """A run of controlled modular multiplies as ONE pass, STANDARD layout
    (work register in the LOW M bits; controls are bits >= M of the index).
    out[idx_hi, f] = in[idx_hi, (combo(ctrl bits of idx_hi) * f) mod C]."""
    dim = state.shape[0]
    m_dim = 1 << M
    outer = dim >> M
    hi = lax.iota(jnp.int32, outer)[:, None]
    f = jnp.arange(m_dim, dtype=jnp.int32)[None, :]
    # Control bits are absolute index bits: bit c of the index = bit (c - M)
    # of the high part.
    src = _ladder_src_rows(C, A_list, [c - M for c in controls], hi, f, M)  # (outer, m_dim)
    x = state.reshape(outer, m_dim)
    return jnp.take_along_axis(x, src, axis=1).reshape(dim)


def probabilities(state: jax.Array) -> jax.Array:
    return jnp.real(state * jnp.conj(state))


def norm(state: jax.Array) -> jax.Array:
    return jnp.sum(probabilities(state))


def sample_index(state: jax.Array, r: jax.Array) -> jax.Array:
    """Inverse-CDF measurement: smallest index with cumulative |amp|^2 >= r,
    falling through to the last index (qc_shor.c:283-292)."""
    cum = jnp.cumsum(probabilities(state))
    idx = jnp.searchsorted(cum, r.astype(cum.dtype), side="left")
    return jnp.minimum(idx, state.shape[0] - 1)


def collapse(state: jax.Array, index: jax.Array) -> jax.Array:
    """Project onto the measured basis state (qc_shor.c:302-303)."""
    dim = state.shape[0]
    onehot = (jnp.arange(dim) == index).astype(state.dtype)
    return onehot


def measure(state: jax.Array, key: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Draw one uniform, sample an index, collapse.  Returns (index, state)."""
    r = jax.random.uniform(key, dtype=jnp.float64 if state.dtype == jnp.complex128 else jnp.float32)
    idx = sample_index(state, r)
    return idx, collapse(state, idx)
