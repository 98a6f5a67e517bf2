"""Single-device state-vector engine: jit-compiled circuit execution.

The engine replaces the reference's Register + gate-engine layers
(qc_shor.c:194-203, 354-690).  Key differences:

  * no double buffering / pointer swap (qc_shor.c:242-249): XLA's functional
    semantics + buffer donation give the same O(1)-copy behavior;
  * a whole circuit compiles as ONE XLA program (hashable Circuit IR), so
    diagonal gates fuse into neighboring passes and there is no per-gate
    dispatch from Python;
  * dtype is configurable: complex64 for throughput, complex128 for the
    reference's double-precision parity envelope (Report §III.F) — requires
    jax_enable_x64 — and "complex32", bf16 planes in device memory with
    every gate computed in f32.

Every gate is an XLA op (ops/gates.py).  Layouts: 'standard' (reference
bit convention) and 'm_high' (work register in the top physical bits: the
oracle is a whole-row gather and the butterflies land on low qubits).
"""

from __future__ import annotations

from dataclasses import dataclass
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
from quantumcomputer.ops import gates as xops
from quantumcomputer.ops import measure as measure_ops
from quantumcomputer.sim import statevec as sv


@dataclass(frozen=True)
class Register:
    """Qubit register geometry (qc_shor.c:194-203): L counting qubits in the
    high bits [M, N), M work qubits in the low bits [0, M)."""

    L: int
    M: int

    @property
    def n(self) -> int:
        return self.L + self.M

    @property
    def num_states(self) -> int:
        return 1 << self.n


def apply_gate(state: jax.Array, g: Gate, M: int, tables=()) -> jax.Array:
    """Dispatch one Gate onto the state.  Static metadata (qubits, angles,
    moduli) is Python-level, so everything specializes under jit.  `tables`
    carries the runtime permutation operands for SLOT oracle gates (the
    compile-once trial-loop form; models/shor_circuit.shor_circuit_template)."""
    name = g.name
    if name == "camodc_slot":
        return xops.apply_c_amodc_dyn(state, tables[g.meta[0]], g.qubits[0], M)
    if name == "camodc_high_slot":
        slot, m_reg = g.meta
        return xops.apply_camodc_high_dyn(state, tables[slot], g.qubits[0], m_reg)
    if name in DENSE_1Q:
        return xops.apply_1q(state, jnp.asarray(gate_matrix_1q(g)), g.qubits[0])
    if name in DIAGONAL_1Q:
        m = gate_matrix_1q(g)
        return xops.apply_diag_1q(state, jnp.asarray(np.diagonal(m)), g.qubits[0])
    if name in ("cz", "cphase"):
        m = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits if g.qubits[0] > g.qubits[1] else (g.qubits[1], g.qubits[0])
        return xops.apply_diag_2q(state, jnp.asarray(np.diagonal(m)), q_hi, q_lo)
    if name == "mcphase":
        return xops.apply_mcphase(state, g.qubits, g.params[0])
    if name in ("cnot", "swap", "u2q"):
        m = gate_matrix_2q(g)
        q_hi, q_lo = g.qubits
        if q_hi < q_lo:
            # reorder qubits; permute the 4x4 basis accordingly (swap bit roles)
            q_hi, q_lo = q_lo, q_hi
            p = [0, 2, 1, 3]
            m = m[np.ix_(p, p)]
        return xops.apply_2q(state, jnp.asarray(m), q_hi, q_lo)
    if name == "camodc":
        C, atox = g.meta
        return xops.apply_c_amodc(state, C, atox, g.qubits[0], M)
    if name == "camodc_strict":
        # Opt-in reference bug-compatibility (warn-and-wrap undersized-M
        # scatter; non-unitary) — emitted by the strict_reference engine's
        # circuit rewrite, never by the builders.
        C, atox = g.meta
        return xops.apply_c_amodc_strict(state, C, atox, g.qubits[0], M)
    if name == "camodc_high":
        C, atox, m_reg = g.meta
        return xops.apply_camodc_high(state, C, atox, g.qubits[0], m_reg)
    if name == "camodc_ladder":
        C, m_reg = g.meta[0], g.meta[1]
        return xops.apply_camodc_ladder(state, C, g.meta[2:], g.qubits, m_reg)
    if name == "camodc_ladder_high":
        C, m_reg = g.meta[0], g.meta[1]
        return xops.apply_camodc_ladder_high(state, C, g.meta[2:], g.qubits, m_reg)
    if name == "iqft_stage":
        return xops.apply_iqft_stage(state, g.qubits[0], M)
    raise ValueError(f"unknown gate: {g}")


def _nan_hook_planes(re: jax.Array, im: jax.Array, label: str) -> None:
    """jax.debug NaN/Inf check (SURVEY.md §5 race-detection analog): prints
    from inside the compiled program when the state goes non-finite."""
    bad = jnp.logical_not(jnp.isfinite(re).all() & jnp.isfinite(im).all())
    jax.lax.cond(
        bad,
        lambda: jax.debug.print("*** non-finite amplitudes after " + label),
        lambda: None,
    )


def _nan_hook(state: jax.Array, label: str) -> None:
    _nan_hook_planes(jnp.real(state), jnp.imag(state), label)


def apply_gate_planes(re: jax.Array, im: jax.Array, g: Gate, M: int, tables=()) -> Tuple[jax.Array, jax.Array]:
    """Dispatch one Gate onto planar planes through the complex path; XLA
    fuses the real/imag/complex conversions into the gate's own pass.
    bf16 "complex32" planes are upcast to complex64 for the gate and
    rounded back to bf16 (inside one program XLA:GPU was measured keeping
    the f32 values between gates instead, PERF.md)."""
    rdtype = re.dtype
    if rdtype == jnp.bfloat16:
        z = jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))
    else:
        z = jax.lax.complex(re, im)
    z = apply_gate(z, g, M, tables=tables)
    return jnp.real(z).astype(rdtype), jnp.imag(z).astype(rdtype)


MAX_LADDER_RUN = 8  # caps the 2^K combo table


def fuse_oracle_ladders(
    circuit: Circuit, M: int, eligible=None, max_run: int = MAX_LADDER_RUN, min_run: int = 2
) -> Circuit:
    """Rewrite maximal runs of >= min_run modular-multiply gates (same C,
    same work register) into single composed-ladder gates.

    The gates all multiply the work register by constants mod C, so they
    COMMUTE and a run of K composes into one permutation whose multiplier
    is selected by the K control bits (ops/gates.modexp_combo_multipliers).
    The Shor circuit applies its L oracles back to back (qc_shor.c:728-731),
    so the dominant cost — K full-state oracle passes — collapses to one.

    `eligible(gate)` (optional) limits which gates may join a run (the
    mesh appliers admit only gates whose ladder they can route).

    `min_run` raises the fusion threshold: the MESH appliers pass the
    device count D, because a fused m_high ladder pays (D-1) full-shard
    ppermute rounds while K packed singles pay ~K*(D-1)/D shards —
    fusing below K = D moves MORE bytes than not fusing (ROADMAP item 2;
    ties at K = D go to the ladder: fewer dispatches)."""
    out: list = []
    gates = list(circuit)
    i = 0
    while i < len(gates):
        g = gates[i]
        if g.name in ("camodc", "camodc_high") and (eligible is None or eligible(g)):
            C = g.meta[0]
            m_reg = g.meta[2] if g.name == "camodc_high" else M
            j = i + 1
            while j < len(gates):
                if j - i >= max_run:
                    break  # caps the 2^K table; longer runs split
                h = gates[j]
                if h.name != g.name or h.meta[0] != C:
                    break
                if eligible is not None and not eligible(h):
                    break
                if g.name == "camodc_high" and h.meta[2] != m_reg:
                    break
                if h.qubits[0] in {gates[k].qubits[0] for k in range(i, j)}:
                    break  # repeated control: composition is still valid only
                           # for distinct control bits (one bit per factor)
                j += 1
            # C must fit the work register: an undersized-M ladder would
            # bypass the per-gate paths' 2^M >= C validation — leave such
            # gates unfused so the gate path raises its clean error.
            if j - i >= max(2, min_run) and C * C < (1 << 31) and C <= (1 << m_reg):
                run = gates[i:j]
                name = "camodc_ladder_high" if g.name == "camodc_high" else "camodc_ladder"
                out.append(
                    Gate(
                        name,
                        qubits=tuple(h.qubits[0] for h in run),
                        meta=(C, m_reg) + tuple(int(h.meta[1]) % C for h in run),
                    )
                )
                i = j
                continue
        out.append(g)
        i += 1
    return tuple(out)


# Composed ladders lower to a take_along_axis over a materialized
# full-state int32 index tensor (4 more bytes per amplitude): fused only up
# to this size, where the saved passes are worth more than the index.
LADDER_FUSE_MAX_DIM = 1 << 24


def planned_circuit(circuit: Circuit, M: int, dim: int, fuse: bool = True) -> Circuit:
    """The gate list the engine executes for `circuit` on a `dim`-amplitude
    state: oracle runs composed into ladders when fusion is on and the
    state is small enough (LADDER_FUSE_MAX_DIM), the circuit as given
    otherwise.  One pass per entry."""
    if fuse and dim <= LADDER_FUSE_MAX_DIM:
        return fuse_oracle_ladders(circuit, M)
    return circuit


def apply_circuit_planes(
    re: jax.Array,
    im: jax.Array,
    circuit: Circuit,
    M: int,
    fuse: bool = True,
    trace_norms: bool = False,
    nan_checks: bool = False,
    tables=(),
):
    """Apply a whole circuit to planar planes.  This is the path of bf16
    "complex32" storage, which has no complex counterpart: every gate reads
    bf16, computes in f32 and stores bf16 (apply_gate_planes).
    trace_norms/nan_checks as in apply_circuit (norms accumulate in f32
    for bf16 planes)."""
    norms: list = []
    acc = jnp.float64 if re.dtype == jnp.float64 else jnp.float32
    for i, g in enumerate(planned_circuit(circuit, M, re.shape[-1], fuse)):
        re, im = apply_gate_planes(re, im, g, M, tables=tables)
        if trace_norms:
            norms.append(jnp.sum(re.astype(acc) ** 2) + jnp.sum(im.astype(acc) ** 2))
        if nan_checks:
            _nan_hook_planes(re, im, f"gate {i} {g.name}{g.qubits}")
    if trace_norms:
        return (re, im), norms
    return re, im


def apply_circuit(
    state: jax.Array,
    circuit: Circuit,
    M: int,
    fuse: bool = True,
    trace_norms: bool = False,
    nan_checks: bool = False,
    tables=(),
):
    """Apply a whole circuit to a (traced) complex state, one gate per pass.

    trace_norms=True additionally returns the post-gate norm list — the
    probability-conservation oracle of Report §IV.A / FIG. 2, evaluated on
    the production path.  nan_checks=True inserts a jax.debug non-finite
    check after every gate."""
    norms: list = []
    for i, g in enumerate(planned_circuit(circuit, M, state.shape[-1], fuse)):
        state = apply_gate(state, g, M, tables=tables)
        if trace_norms:
            norms.append(xops.norm(state))
        if nan_checks:
            _nan_hook(state, f"gate {i} {g.name}{g.qubits}")
    if trace_norms:
        return state, norms
    return state


def _circuit_planes_from_reset(n, rdtype, r0, circuit, M, fuse, nan_checks, tables=()):
    """Reset -> circuit, returning planes.  f32/f64 thread a complex state;
    bf16 "complex32" storage has no complex dtype, so it runs the planar
    path end to end."""
    if rdtype == jnp.bfloat16:
        re, im = sv.initial_planes(n, rdtype, r0)
        return apply_circuit_planes(re, im, circuit, M, fuse, nan_checks=nan_checks, tables=tables)
    state = sv.initial_complex(n, rdtype, r0)
    state = apply_circuit(state, circuit, M, fuse, nan_checks=nan_checks, tables=tables)
    return jnp.real(state), jnp.imag(state)


def compute_plane_dtype(rdtype):
    """The dtype a program's TEMPORARIES actually occupy: bf16 is a
    STORAGE format — every gate upcasts to f32, so memory planning for
    bf16 states must count f32 bytes for two-state (out-of-place)
    programs."""
    return jnp.float32 if jnp.dtype(rdtype) == jnp.bfloat16 else jnp.dtype(rdtype)


def two_state_programs_fit(n: int, rdtype) -> bool:
    """True when a program holding TWO full states in planes of `rdtype`
    (e.g. an out-of-place oracle gather) fits the single-device memory
    budget (device-derived; see utils/memory.py).

    `rdtype` must be the dtype the buffers ACTUALLY occupy: pass
    compute_plane_dtype(engine dtype) — an n=30 'complex32' template
    program really peaks at two f32 states."""
    from quantumcomputer.utils.memory import device_hbm_budget

    return 2 * (1 << n) * jnp.dtype(rdtype).itemsize * 2 <= device_hbm_budget()


def _x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


class StateVectorEngine:
    """Executes circuits on a 2^n amplitude vector resident on device.

    Boundary representation is *planar*: states entering/leaving jitted
    programs are (2, 2^n) real arrays (re/im planes — see sim/statevec.py);
    complex dtype exists only inside traced computations.  Programs that
    start from the reset state and return a scalar (run_norm,
    run_and_measure_index) never cross that boundary with a state.
    """

    def __init__(
        self,
        register: Register,
        dtype=jnp.complex64,
        fuse: bool = True,
        layout: str = "standard",
        nan_checks: bool = False,
        strict_reference: bool = False,
    ):
        if strict_reference and layout != "standard":
            # Reference bug-compatibility mode (qc_shor.c:340-351, 654):
            # modular-multiply gates run the warn-and-wrap scatter even when
            # 2^M < C (non-unitary collisions), for side-by-side comparison
            # runs against the original binary: standard layout only.
            raise ValueError("strict_reference mode requires the standard layout")
        if layout not in ("standard", "m_high"):
            raise ValueError(f"unknown layout {layout!r}")
        if register.n > 31 and not _x64_enabled():
            # The single-device sampler/collapse index math is int32: basis
            # indices fit exactly up to n = 31 (2^31 - 1).  The reference
            # documents its own 32-qubit bound the same way
            # (qc_shor.c:68-73); the mesh engine reaches n = 32 by keeping
            # (device, local) index pairs.  See tests/test_index_width.py.
            raise ValueError(
                f"n = L + M = {register.n} > 31 exceeds the int32 basis-index "
                "budget of a single device; enable jax_enable_x64 or "
                "shard over a mesh (ShardedStateVectorEngine)"
            )
        self.register = register
        if isinstance(dtype, str) and dtype in (sv.COMPLEX32, "c32"):
            # bf16-STORAGE mode: every gate computes in f32 and rounds to
            # bf16 on the store, halving the bytes each pass moves.
            self.dtype = sv.COMPLEX32
        else:
            self.dtype = jnp.dtype(dtype)
        self.real_dtype = sv.real_dtype_of(dtype)
        self.fuse = fuse
        self.layout = layout
        self.nan_checks = nan_checks
        self.strict_reference = strict_reference
        # In the M-high layout the L register occupies the low physical bits
        # and the iQFT ladder boundary is physical bit 0 (see
        # models/shor_circuit.shor_circuit_mhigh).
        self.m_eff = 0 if layout == "m_high" else register.M
        self.reset_index = (1 << register.L) if layout == "m_high" else 1
        self._run_cache: dict = {}

    def _prep(self, circuit: Circuit) -> Circuit:
        """Engine-level circuit rewrite: in strict_reference mode every
        modular-multiply gate becomes its warn-and-wrap scatter twin."""
        if not self.strict_reference:
            return circuit
        return tuple(
            Gate("camodc_strict", g.qubits, g.params, g.meta) if g.name == "camodc" else g
            for g in circuit
        )

    # -- state lifecycle ----------------------------------------------------

    def initial_state(self) -> jax.Array:
        """|00...01> (qc_shor.c:318-324), planar (layout-aware)."""
        return sv.initial_planar(self.register.n, self.real_dtype, self.reset_index)

    def logical_index(self, phys: int) -> int:
        """Map a measured physical basis index back to the logical (reference
        bit-convention) index."""
        if self.layout == "standard":
            return phys
        L, M = self.register.L, self.register.M
        return (phys >> L) | ((phys & ((1 << L) - 1)) << M)

    def zero_state(self) -> jax.Array:
        return sv.zero_planar(self.register.n, self.real_dtype)

    # -- execution ----------------------------------------------------------

    def _compiled_run(self, circuit: Circuit, with_norms: bool) -> Callable:
        key = (circuit, with_norms, self.nan_checks)
        fn = self._run_cache.get(key)
        if fn is None:
            M, fuse, nan_checks = self.m_eff, self.fuse, self.nan_checks

            def apply(planar, circ, trace_norms=False, checks=False):
                if planar.dtype == jnp.bfloat16:
                    out = apply_circuit_planes(
                        planar[0], planar[1], circ, M, fuse,
                        trace_norms=trace_norms, nan_checks=checks,
                    )
                    if trace_norms:
                        return jnp.stack(out[0]), out[1]
                    return jnp.stack(out)
                out = apply_circuit(
                    sv.to_complex(planar), circ, M, fuse,
                    trace_norms=trace_norms, nan_checks=checks,
                )
                if trace_norms:
                    return sv.from_complex(out[0]), out[1]
                return sv.from_complex(out)

            if with_norms:

                def run(planar):
                    out, norms = apply(planar, circuit, trace_norms=True, checks=nan_checks)
                    acc = jnp.float32 if planar.dtype == jnp.bfloat16 else planar.dtype
                    return out, (jnp.stack(norms) if norms else jnp.zeros((0,), acc))

            else:
                # Unitary circuits back-propagate exactly with O(1) memory:
                # the cotangent transforms by U^dagger (the real-linear
                # transpose of the complex-linear map IS the adjoint
                # circuit), so no intermediate states are ever saved and
                # no op needs its own derivative rule.
                from quantumcomputer.models.circuit import dagger_circuit

                # strict_reference gates are non-unitary scatters: no
                # adjoint exists, so the backprop rule is skipped.
                adj = None if self.strict_reference else dagger_circuit(circuit, M)

                def run_impl(planar):
                    return apply(planar, circuit, checks=nan_checks)

                if adj is None:
                    run = run_impl
                else:
                    run = jax.custom_vjp(run_impl)

                    def _fwd(planar):
                        return run_impl(planar), None

                    def _bwd(_, ct):
                        return (apply(ct, adj),)

                    run.defvjp(_fwd, _bwd)

            fn = jax.jit(run, donate_argnums=(0,))
            self._run_cache[key] = fn
        return fn

    def run(self, circuit: Circuit, state: Optional[jax.Array] = None) -> jax.Array:
        """Apply a circuit; one jit program per distinct circuit.
        Input/output states are planar (2, 2^n) arrays.  With no input
        state, the |0..01> reset is folded into the compiled program
        (one executable, no eager initialization ops).

        CONSUMES a caller-supplied `state` (buffer donation — the
        equivalent of the reference's pointer swap, qc_shor.c:242-249): the
        input buffer is reused for the output and must not be touched again.
        Keep a copy (`state + 0`) if you need the pre-circuit state."""
        circuit = self._prep(circuit)
        if state is None:
            return self._compiled_from_reset(circuit, "reset", lambda re, im: jnp.stack([re, im]))()
        return self._compiled_run(circuit, with_norms=False)(state)

    def _compiled_from_reset(
        self, circuit: Circuit, kind: str, tail: Callable, with_tables: bool = False,
        key_extra: tuple = (),
    ) -> Callable:
        """One compiled program: reset -> circuit -> tail(re, im, *rest).
        Its operands are (tables, *rest) with_tables, else (*rest)."""
        ck = (circuit, kind, self.nan_checks) + key_extra
        fn = self._run_cache.get(ck)
        if fn is None:
            M, fuse, nan_checks = self.m_eff, self.fuse, self.nan_checks
            n, rdtype, r0 = self.register.n, self.real_dtype, self.reset_index

            def run(*args):
                tables, rest = (args[0], args[1:]) if with_tables else ((), args)
                re, im = _circuit_planes_from_reset(
                    n, rdtype, r0, circuit, M, fuse, nan_checks, tables=tables
                )
                return tail(re, im, *rest)

            fn = jax.jit(run)
            self._run_cache[ck] = fn
        return fn

    def run_norm(self, circuit: Circuit) -> float:
        """Reset -> circuit -> norm, as ONE compiled program whose only
        output is the scalar norm: no state-sized buffer crosses the
        program boundary, so the program peak is the circuit's own.

        Also the natural timing/validation entry point: one dispatch, one
        scalar fetch, and the fetched norm doubles as a probability-
        conservation check (Report §IV.A)."""

        def norm(re, im):
            acc = jnp.float32 if re.dtype == jnp.bfloat16 else re.dtype
            re, im = re.astype(acc), im.astype(acc)
            return jnp.sum(re * re) + jnp.sum(im * im)

        return float(self._compiled_from_reset(self._prep(circuit), "norm", norm)())

    def run_marginal(self, circuit: Circuit, low_bits: int) -> jax.Array:
        """Reset -> circuit -> the marginal distribution of the `low_bits`
        lowest PHYSICAL qubits (|amp|^2 summed over the others), as ONE
        compiled program with a (2^low_bits,) output — in the m_high layout
        the L register's physical distribution.  Accumulates in f32 for
        bf16/f32 planes, f64 for f64."""

        def marginal(re, im):
            acc = measure_ops.acc_dtype(re.dtype)
            p = re.astype(acc) ** 2 + im.astype(acc) ** 2
            return jnp.sum(p.reshape(-1, 1 << low_bits), axis=0)

        return self._compiled_from_reset(
            self._prep(circuit), "marginal", marginal, key_extra=(low_bits,)
        )()

    def run_and_measure(self, circuit: Circuit, key: jax.Array) -> Tuple[int, jax.Array]:
        """Reset -> circuit -> inverse-CDF measurement, as ONE compiled
        program (find_period's whole quantum step, qc_shor.c:922-928).
        Returns (measured index, collapsed planar state).  When the
        collapsed state is not needed, use run_and_measure_index — the
        collapse output is a full extra state buffer."""

        def measure(re, im, k):
            idx = _sample_index_planes(re, im, k)
            onehot = (jnp.arange(re.shape[-1]) == idx).astype(re.dtype)
            return idx, jnp.stack([onehot, jnp.zeros_like(onehot)])

        fn = self._compiled_from_reset(self._prep(circuit), "measure", measure)
        idx, collapsed = fn(key)
        return int(idx), collapsed

    def run_and_measure_index(self, circuit: Circuit, key: jax.Array) -> int:
        """Reset -> circuit -> measured index, as ONE compiled program with
        a SCALAR output.  The collapse is dead code here, so the program
        holds only one state buffer — the memory-ceiling-safe form of the
        period-finding quantum step (the reference discards the collapsed
        state too: find_period uses only the index, qc_shor.c:928-929)."""
        # The tables form with an EMPTY operand tuple is the same program
        # (no leaves reach the jaxpr), so both entry points share one
        # builder and one compiled executable per circuit.
        return self.run_and_measure_index_with_tables(circuit, (), key)

    def run_and_measure_index_with_tables(self, circuit: Circuit, tables, key: jax.Array) -> int:
        """run_and_measure_index for TEMPLATE circuits whose oracle gates
        are SLOT gates (camodc_slot / camodc_high_slot): the permutation
        tables are program OPERANDS, so ONE compiled program serves every
        trial integer — the unforced trial loop (qc_shor.c:1072-1120)
        stops paying a fresh XLA compile per `a`.

        `tables` is a sequence of int32 (2^m,) inverse-permutation arrays,
        indexed by each slot gate's meta[0]
        (models/shor_circuit.shor_oracle_tables builds them)."""
        fn = self._compiled_from_reset(
            self._prep(circuit), "measure_idx_dyn", _sample_index_planes, with_tables=True,
            key_extra=(len(tables),),
        )
        tabs = tuple(jnp.asarray(np.asarray(t), jnp.int32) for t in tables)
        return int(fn(tabs, key))

    def run_with_norms(self, circuit: Circuit, state: Optional[jax.Array] = None) -> Tuple[jax.Array, jax.Array]:
        """Apply a circuit, also returning the post-gate norm trace — the
        probability-conservation oracle of Report §IV.A / FIG. 2, on the
        production execution path.

        CONSUMES a caller-supplied `state` (buffer donation), like run()."""
        circuit = self._prep(circuit)
        if state is None:
            state = self.initial_state()
        return self._compiled_run(circuit, with_norms=True)(state)

    # -- measurement ----------------------------------------------------------

    def measure(self, state: jax.Array, key: jax.Array) -> Tuple[int, jax.Array]:
        """Single inverse-CDF measurement + collapse (qc_shor.c:272-306).
        Returns (measured basis index, collapsed planar state).  Pure real
        arithmetic — no complex dtype anywhere.

        CONSUMES the input state (buffer donation): the pre-measurement
        state is gone afterwards, enforcing the reference's no-remeasure
        semantic (qc_shor.c:299-301) at the buffer level.  Use sample()
        BEFORE measure() for non-collapsing statistics, or re-run the
        circuit for another physical shot."""
        idx, collapsed = _measure_planar(state, key)
        return int(idx), collapsed

    def sample(self, state: jax.Array, key: jax.Array, shots: int) -> jax.Array:
        """Draw `shots` independent basis indices from |amp|^2 WITHOUT
        collapsing (a statistics/debug convenience: physical runs re-execute
        the circuit per shot — see utils/experiments.omega_histogram).

        Large f32/bf16 states sample in two levels (one block-sum pass +
        per-shot work bounded by one block — no full-state probability
        vector or cumsum is ever materialized); small/f64 states use the
        flat scan matching the reference order exactly (ops/measure.py)."""
        fn = self._run_cache.get(("__sample__", shots, state.shape))
        if fn is None:

            @jax.jit
            def fn(planar, k):
                rdt = jnp.float32 if planar.dtype == jnp.bfloat16 else planar.dtype
                return measure_ops.sample_indices(planar, jax.random.uniform(k, (shots,), dtype=rdt))

            self._run_cache[("__sample__", shots, state.shape)] = fn
        return fn(state, key)

    def probabilities(self, state: jax.Array) -> jax.Array:
        return sv.probabilities(state)

    def norm(self, state: jax.Array) -> float:
        return float(sv.norm(state))

    def to_numpy(self, state: jax.Array):
        """Host-side complex view of a planar state (for inspection/tests)."""
        return sv.to_numpy_complex(state)


def _sample_index_planes(re: jax.Array, im: jax.Array, key: jax.Array) -> jax.Array:
    """Inverse-CDF sample from separate re/im planes (qc_shor.c:272-306):
    two-level for large f32/bf16 states, the flat scan otherwise
    (ops/measure.py).  Draws are f32 even for bf16 planes (a bf16 uniform
    has ~8 bits of resolution)."""
    r = jax.random.uniform(key, dtype=jnp.float32 if re.dtype == jnp.bfloat16 else re.dtype)
    return measure_ops.sample_index(re, im, r)


def _measure_planar_impl(planar: jax.Array, key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Inverse-CDF sample + collapse on planar state (qc_shor.c:272-306)."""
    dim = planar.shape[-1]
    idx = _sample_index_planes(planar[0], planar[1], key)
    onehot = (jnp.arange(dim) == idx).astype(planar.dtype)
    collapsed = jnp.stack([onehot, jnp.zeros_like(onehot)])
    return idx, collapsed


_measure_planar = partial(jax.jit, donate_argnums=(0,))(_measure_planar_impl)
