"""Double-float state-vector engine: 1e-12 parity from f32 arithmetic.

The reference argues double precision is required for normalization
fidelity (Report §III.F) and carries GSL complex-doubles throughout
(qc_shor.c:105-112).  This engine carries every amplitude as two f32
pairs — re/im each as an unevaluated (hi, lo) sum with ~49 mantissa bits
(see ops/dd.py) — for devices without fast float64.  Full-circuit
amplitudes match the float64 CPU oracle (sim/reference.py) to <= 1e-12
for the register sizes the reference demonstrates.

State representation at the jit boundary: a (4, 2^n) float32 array with
rows [re_hi, re_lo, im_hi, im_lo].

API-compatible with StateVectorEngine for everything the Shor driver and
the verbosity/measurement paths use: initial_state, run, run_and_measure,
run_with_norms, measure, sample, probabilities, norm, to_numpy,
logical_index.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quantumcomputer.models.circuit import (
    DENSE_1Q,
    DIAGONAL_1Q,
    Circuit,
    Gate,
    gate_matrix_1q,
    gate_matrix_2q,
)
from quantumcomputer.ops import dd
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim.engine import Register

# -- dd state helpers ---------------------------------------------------------
# A dd state is a tuple (re: DD, im: DD) of (hi, lo) pairs, each (2^n,).


def _unpack(planar4: jax.Array):
    return (planar4[0], planar4[1]), (planar4[2], planar4[3])


def _pack(re: dd.DD, im: dd.DD) -> jax.Array:
    return jnp.stack([re[0], re[1], im[0], im[1]])


def _dd_const_c(z: complex) -> Tuple[dd.DD, dd.DD]:
    """Host complex -> (re, im) dd scalar constants."""
    return dd.const(float(np.real(z))), dd.const(float(np.imag(z)))


def _view_1q(x, q: int):
    """(dim,) -> (outer, 2, inner) exposing qubit q as the middle axis."""
    dim = x.shape[-1]
    inner = 1 << q
    return x.reshape(dim // (2 * inner), 2, inner)


def _apply_1q(re: dd.DD, im: dd.DD, u: np.ndarray, q: int):
    """Dense 1-qubit gate contraction in dd complex arithmetic."""
    rh, rl = _view_1q(re[0], q), _view_1q(re[1], q)
    ih, il = _view_1q(im[0], q), _view_1q(im[1], q)
    x = [((rh[:, b], rl[:, b]), (ih[:, b], il[:, b])) for b in (0, 1)]
    out = []
    for row in (0, 1):
        accr, acci = dd.zeros(x[0][0][0].shape), dd.zeros(x[0][0][0].shape)
        for col in (0, 1):
            z = complex(u[row, col])
            if z == 0:
                continue
            ar, ai = _dd_const_c(z)
            pr, pi = dd.cmul(ar, ai, x[col][0], x[col][1])
            accr, acci = dd.add(accr, pr), dd.add(acci, pi)
        out.append((accr, acci))
    new_re = (
        jnp.stack([out[0][0][0], out[1][0][0]], 1).reshape(re[0].shape),
        jnp.stack([out[0][0][1], out[1][0][1]], 1).reshape(re[0].shape),
    )
    new_im = (
        jnp.stack([out[0][1][0], out[1][1][0]], 1).reshape(im[0].shape),
        jnp.stack([out[0][1][1], out[1][1][1]], 1).reshape(im[0].shape),
    )
    return new_re, new_im


def _apply_phase_masked(re: dd.DD, im: dd.DD, z: complex, mask):
    """amp *= z where mask (bool, (dim,)), identity elsewhere, in dd."""
    ar, ai = _dd_const_c(z)
    pr, pi = dd.cmul(ar, ai, re, im)
    sel = lambda new, old: jnp.where(mask, new, old)
    return (
        (sel(pr[0], re[0]), sel(pr[1], re[1])),
        (sel(pi[0], im[0]), sel(pi[1], im[1])),
    )


def _bit_mask(dim: int, q: int):
    idx = jnp.arange(dim, dtype=jnp.int32 if dim <= (1 << 30) else jnp.int64)
    return ((idx >> q) & 1) == 1


def _apply_2q(re: dd.DD, im: dd.DD, u4: np.ndarray, q_hi: int, q_lo: int):
    """Dense 2-qubit gate (basis 2*bit(q_hi) + bit(q_lo)) in dd."""
    dim = re[0].shape[-1]
    inner = 1 << q_lo
    mid = 1 << (q_hi - q_lo - 1)
    outer = dim // (4 * inner * mid)
    shape = (outer, 2, mid, 2, inner)

    def view(a):
        return a.reshape(shape)

    rh, rl, ih, il = view(re[0]), view(re[1]), view(im[0]), view(im[1])
    x = {}
    for bh in (0, 1):
        for bl in (0, 1):
            x[2 * bh + bl] = (
                (rh[:, bh, :, bl], rl[:, bh, :, bl]),
                (ih[:, bh, :, bl], il[:, bh, :, bl]),
            )
    out = {}
    for row in range(4):
        accr, acci = dd.zeros(x[0][0][0].shape), dd.zeros(x[0][0][0].shape)
        for col in range(4):
            z = complex(u4[row, col])
            if z == 0:
                continue
            ar, ai = _dd_const_c(z)
            pr, pi = dd.cmul(ar, ai, x[col][0], x[col][1])
            accr, acci = dd.add(accr, pr), dd.add(acci, pi)
        out[row] = (accr, acci)

    def assemble(pick):
        rows = [[pick(0), pick(1)], [pick(2), pick(3)]]
        return jnp.stack(
            [jnp.stack([rows[0][0], rows[0][1]], 2), jnp.stack([rows[1][0], rows[1][1]], 2)], 1
        ).reshape(dim)

    new_re = (assemble(lambda k: out[k][0][0]), assemble(lambda k: out[k][0][1]))
    new_im = (assemble(lambda k: out[k][1][0]), assemble(lambda k: out[k][1][1]))
    return new_re, new_im


def apply_gate_dd(re: dd.DD, im: dd.DD, g: Gate, M: int):
    """Dispatch one Gate in dd arithmetic (gate set of engine.apply_gate)."""
    name = g.name
    dim = re[0].shape[-1]
    if name in DENSE_1Q:
        return _apply_1q(re, im, gate_matrix_1q(g), g.qubits[0])
    if name in DIAGONAL_1Q:
        d = np.diagonal(gate_matrix_1q(g))
        q = g.qubits[0]
        if complex(d[0]) != 1.0 + 0.0j:
            re, im = _apply_phase_masked(re, im, complex(d[0]), ~_bit_mask(dim, q))
        if complex(d[1]) != 1.0 + 0.0j:
            re, im = _apply_phase_masked(re, im, complex(d[1]), _bit_mask(dim, q))
        return re, im
    if name in ("cz", "cphase"):
        d4 = np.diagonal(gate_matrix_2q(g))
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        # Only the |11> slot differs from 1 for cz/cphase.
        mask = _bit_mask(dim, q_hi) & _bit_mask(dim, q_lo)
        return _apply_phase_masked(re, im, complex(d4[3]), mask)
    if name in ("cnot", "swap", "u2q"):
        m4 = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits
        if q_hi < q_lo:
            q_hi, q_lo = q_lo, q_hi
            p = [0, 2, 1, 3]
            m4 = m4[np.ix_(p, p)]
        return _apply_2q(re, im, m4, q_hi, q_lo)
    if name == "camodc":
        C, atox = g.meta
        ginv = jnp.asarray(xops.modmul_inverse_permutation(C, atox, M))
        c_q = g.qubits[0]
        m_dim = 1 << M

        def permute(a):
            x = a.reshape(-1, m_dim)
            return jnp.take(x, ginv, axis=-1).reshape(a.shape)

        ctrl = _bit_mask(dim, c_q)
        sel = lambda a: jnp.where(ctrl, permute(a), a)
        return (sel(re[0]), sel(re[1])), (sel(im[0]), sel(im[1]))
    if name == "iqft_stage":
        # Expand to the reference's gate-for-gate ladder (qc_shor.c:682-688):
        # H(l), then CPHASE(l, k, pi/2^(l-k)) for k = l-1 .. M.  Scalar phase
        # constants are host-split f64 -> dd, so each is ~1e-15 accurate.
        l = g.qubits[0]
        re, im = _apply_1q(re, im, gate_matrix_1q(Gate("h", (l,))), l)
        for k in range(l - 1, M - 1, -1):
            theta = math.pi / (1 << (l - k))
            z = complex(math.cos(theta), math.sin(theta))
            mask = _bit_mask(dim, l) & _bit_mask(dim, k)
            re, im = _apply_phase_masked(re, im, z, mask)
        return re, im
    raise ValueError(f"unknown gate for dd engine: {g}")


def _norm_dd(re: dd.DD, im: dd.DD) -> dd.DD:
    """Sum of |amp|^2 in dd: exact products, tree-folded dd accumulation."""
    rr = dd.mul(re, re)
    ii = dd.mul(im, im)
    return dd.tree_sum(dd.add(rr, ii))


class DDStateVectorEngine:
    """Drop-in engine running the double-float parity mode (f64
    substitute).  Single-device, standard layout.

    Each gate compiles as its own program by default (the reference's own
    operate_matrix granularity, qc_shor.c:370-420).  XLA:CPU's
    optimizations recompute shared values into multiple fusion clusters
    with inconsistent rounding once a program grows past a few gates,
    silently corrupting the error-free transforms (measured: 4e-9
    amplitude errors for a 5-gate program; 1e-15 per-gate); per-gate
    programs keep every EFT inside one fusion context.  On an H100 a
    whole-circuit program reached the same error in no less time
    (PERF.md), so per-gate programs are the only form."""

    layout = "standard"
    dtype = "dd64"

    def __init__(self, register: Register, nan_checks: bool = False):
        self.register = register
        self.real_dtype = jnp.float32
        self.nan_checks = nan_checks
        self._run_cache: dict = {}

    # -- state lifecycle ------------------------------------------------------

    def initial_state(self) -> jax.Array:
        """|0..01> as a (4, 2^n) f32 dd-planar array."""
        dim = self.register.num_states
        planar4 = np.zeros((4, dim), np.float32)
        planar4[0, 1] = 1.0
        return jnp.asarray(planar4)

    def zero_state(self) -> jax.Array:
        """|00...0> as dd planes (amplitude 1 at index 0 — matching
        statevec.zero_planar; this used to return the NULL vector)."""
        return jnp.zeros((4, self.register.num_states), jnp.float32).at[0, 0].set(1.0)

    def logical_index(self, phys: int) -> int:
        return phys

    # -- execution -------------------------------------------------------------

    def _gate_fn(self, g: Gate) -> Callable:
        """One compiled program per distinct gate (donating the input)."""
        key = ("gate", g)
        fn = self._run_cache.get(key)
        if fn is None:
            M = self.register.M
            nan_checks = self.nan_checks

            @partial(jax.jit, donate_argnums=(0,))
            def fn(p):
                re, im = _unpack(p)
                re, im = apply_gate_dd(re, im, g, M)
                if nan_checks:
                    from quantumcomputer.sim.engine import _nan_hook_planes

                    _nan_hook_planes(re[0] + re[1], im[0] + im[1], f"{g.name}{g.qubits}")
                return _pack(re, im)

            self._run_cache[key] = fn
        return fn

    def run(self, circuit: Circuit, state: Optional[jax.Array] = None) -> jax.Array:
        """Apply a circuit (per-gate programs; see class docstring).
        CONSUMES a caller-supplied state (donation), like StateVectorEngine."""
        if state is None:
            state = self.initial_state()
        for g in circuit:
            state = self._gate_fn(g)(state)
        return state

    def _norm_hilo_fn(self) -> Callable:
        """The one compiled (hi, lo)-norm program (shared by norm() and
        run_with_norms — identical bodies previously compiled twice)."""
        fn = self._run_cache.get("__norm__")
        if fn is None:

            @jax.jit
            def fn(p):
                re, im = _unpack(p)
                return jnp.stack(_norm_dd(re, im))

            self._run_cache["__norm__"] = fn
        return fn

    def run_with_norms(self, circuit: Circuit, state: Optional[jax.Array] = None):
        """Per-gate dd norm trace; returns (state, norms) with norms a
        float64 host array combined from the dd (hi, lo) pairs."""
        if state is None:
            state = self.initial_state()
        nfn = self._norm_hilo_fn()
        norms = []
        for g in circuit:
            state = self._gate_fn(g)(state)
            hi_lo = np.asarray(nfn(state), np.float64)
            norms.append(hi_lo[0] + hi_lo[1])
        return state, np.asarray(norms)

    def run_and_measure(self, circuit: Circuit, key: jax.Array) -> Tuple[int, jax.Array]:
        """Reset -> circuit (per-gate programs) -> inverse-CDF measurement."""
        state = self.run(circuit, self.initial_state())
        idx, collapsed = _measure_dd(state, key)
        return int(idx), collapsed

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> norm through the per-gate programs (the
        API-uniform counterpart of StateVectorEngine.run_norm)."""
        return self.norm(self.run(circuit, self.initial_state()))

    def run_and_measure_index(self, circuit: Circuit, key: jax.Array) -> int:
        """Reset -> circuit -> measured index through the per-gate programs
        (same draw convention as _measure_dd_impl)."""
        idx, _ = _measure_dd(self.run(circuit, self.initial_state()), key)
        return int(idx)

    # -- measurement -----------------------------------------------------------

    def measure(self, state: jax.Array, key: jax.Array) -> Tuple[int, jax.Array]:
        """Single measurement + collapse.  CONSUMES the input state."""
        idx, collapsed = _measure_dd(state, key)
        return int(idx), collapsed

    def sample(self, state: jax.Array, key: jax.Array, shots: int) -> jax.Array:
        probs = self.probabilities(state)
        cum = jnp.cumsum(probs)
        rs = jax.random.uniform(key, (shots,), dtype=probs.dtype)
        # Scale by the total like _measure_dd_impl (f32 probability drift
        # must not route the deficit to the last basis index).
        return jnp.minimum(jnp.searchsorted(cum, rs * cum[-1], side="left"), probs.shape[-1] - 1)

    # -- inspection --------------------------------------------------------------

    def probabilities(self, state: jax.Array) -> jax.Array:
        re, im = _unpack(state)
        return (re[0] + re[1]) ** 2 + (im[0] + im[1]) ** 2

    def norm(self, state: jax.Array) -> float:
        hi_lo = np.asarray(self._norm_hilo_fn()(state), np.float64)
        return float(hi_lo[0] + hi_lo[1])

    def to_numpy(self, state: jax.Array) -> np.ndarray:
        """complex128 host view, recombining the dd planes exactly."""
        p = np.asarray(state, np.float64)
        return (p[0] + p[1]) + 1j * (p[2] + p[3])


def _measure_dd_impl(planar4: jax.Array, key: jax.Array):
    """Inverse-CDF sample + collapse on a dd state (qc_shor.c:272-306).
    Sampling needs only statistical accuracy: f32 hi+lo probabilities."""
    re, im = _unpack(planar4)
    probs = (re[0] + re[1]) ** 2 + (im[0] + im[1]) ** 2
    dim = probs.shape[-1]
    r = jax.random.uniform(key, dtype=probs.dtype) * jnp.sum(probs)
    cum = jnp.cumsum(probs)
    idx = jnp.minimum(jnp.searchsorted(cum, r, side="left"), dim - 1)
    onehot = (jnp.arange(dim) == idx).astype(jnp.float32)
    zeros = jnp.zeros_like(onehot)
    return idx, jnp.stack([onehot, zeros, zeros, zeros])


_measure_dd = partial(jax.jit, donate_argnums=(0,))(_measure_dd_impl)
