"""Quantum phase estimation as a first-class generic algorithm.

Shor's find_period IS phase estimation specialized to one unitary — the
modular multiply (the reference hard-codes that single instance,
qc_shor.c:712-737).  This module exposes the general algorithm, in both
forms the framework runs it:

  * :func:`qpe_circuit` / :func:`estimate_phase` — the textbook
    full-register form: t counting qubits in superposition, the
    controlled-U^(2^j) ladder, the fused inverse QFT, one measurement.
    Pure circuit IR, so it runs unchanged on the single-device engine
    (any dtype) and on the sharded mesh engine.
  * :func:`run_semiclassical_qpe` — the one-control-qubit Griffiths–Niu
    form (algorithms/semiclassical.py module docstring): U^(2^j) is
    supplied as an UNCONTROLLED circuit on the work register, the control
    qubit is implicit, and the device state is the work register alone —
    t counting qubits for the price of one.

The caller describes U by its controlled powers, exactly how the Shor
circuit builder describes the modular multiply (models/shor_circuit.py
modexp_ladder): ``controlled_powers(j, control)`` returns the gates of
controlled-U^(2^j) with the given control qubit, acting on work qubits
[0, M).  For the semiclassical form only the uncontrolled ``powers(j)``
circuit is needed — the implicit-control algebra supplies the control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence

import jax
import jax.numpy as jnp

from quantumcomputer.algorithms.semiclassical import (
    SemiclassicalRecord,
    _compute_dtype,
    collapse_from_a1,
)
from quantumcomputer.models.circuit import Circuit, Gate, H, IQFT_STAGE
from quantumcomputer.sim import statevec as sv

ControlledPowers = Callable[[int, int], Iterable[Gate]]
Powers = Callable[[int], Iterable[Gate]]


@dataclass
class QPEResult:
    """One phase-estimation measurement: phase = x / 2^t.

    The engine's fused iQFT ladder keeps the reference's POSITIVE-angle
    convention (qc_shor.c:682-688), under which an eigenphase phi reads
    out as x_tilde = -phi*2^t mod 2^t (for Shor it never matters: k/r and
    -k/r share the denominator).  QPE's contract is the true eigenphase,
    so x here is the NEGATED readout, (2^t - x_tilde) mod 2^t — an exact,
    free conversion that preserves the standard QPE distribution (the raw
    readout's distribution is its mirror image).  `raw` keeps the
    unconverted readout for Shor-pipeline interop."""

    x: int                                  # phase numerator: phase = x / 2^t
    t: int                                  # counting-register width
    raw: int                                # bit-reversed readout (read_omega convention)
    record: Optional[SemiclassicalRecord] = None  # semiclassical form only

    @property
    def phase(self) -> float:
        return self.x / float(1 << self.t)


def _negate_readout(x_tilde: int, t: int) -> int:
    return ((1 << t) - x_tilde) % (1 << t)


def qpe_circuit(
    controlled_powers: ControlledPowers, t: int, M: int, prep: Circuit = ()
) -> Circuit:
    """The full-register QPE circuit on a Register(L=t, M=M) engine.

    ``prep`` (optional) acts on the work register first, from the engine's
    |0..01> reset — e.g. to rotate |1> into an eigenstate of U.  Then the
    standard ladder: H on each counting qubit, controlled-U^(2^j) with
    control M+j, and the fused inverse QFT on the counting register (the
    same stages the Shor builder emits, models/shor_circuit.py)."""
    gates: List[Gate] = list(prep)
    gates += [H(M + j) for j in range(t)]
    for j in range(t):
        gates += list(controlled_powers(j, M + j))
    gates += [IQFT_STAGE(l) for l in range(M + t - 1, M - 1, -1)]
    return tuple(gates)


def estimate_phase(
    controlled_powers: ControlledPowers,
    t: int,
    M: int,
    key: jax.Array,
    engine=None,
    dtype=jnp.complex64,
    prep: Circuit = (),
) -> QPEResult:
    """Build the QPE circuit, run it, measure once.

    ``engine`` is any engine with run/measure semantics over a
    Register(L=t, M=M) geometry (StateVectorEngine or the sharded mesh
    engine); default is a single-chip engine of the given dtype.  The
    measured phase is exact when the work register holds an eigenstate
    whose phase has <= t bits; otherwise it concentrates on the best t-bit
    approximation with probability >= 4/pi^2 (standard QPE bound)."""
    if t > 52:
        raise ValueError(f"t={t} > 52 exceeds the float64 phase mantissa (x / 2^t)")
    if engine is None:
        from quantumcomputer.sim.engine import Register, StateVectorEngine

        engine = StateVectorEngine(Register(L=t, M=M), dtype=dtype)
    else:
        # The circuit hard-codes the standard geometry: work at bits
        # [0, M), counting at [M, M+t), iQFT stages at the M boundary.  A
        # mismatched register or an m_high-layout engine would run without
        # error and return a silently wrong phase — reject instead.
        reg = engine.register
        if (reg.L, reg.M) != (t, M):
            raise ValueError(
                f"engine register (L={reg.L}, M={reg.M}) does not match QPE geometry (t={t}, M={M})"
            )
        if getattr(engine, "layout", "standard") != "standard":
            raise ValueError(
                "QPE circuits assume layout='standard' (work register at bits [0, M)); "
                f"got layout={engine.layout!r}"
            )
    circ = qpe_circuit(controlled_powers, t, M, prep)
    state = engine.run(circ)
    idx, _ = engine.measure(state, key)
    idx = engine.logical_index(int(idx))
    # Bit-reversed counting-register readout as EXACT integer arithmetic
    # (the same reversal read_omega performs, qc_shor.c:868-883, minus the
    # float division — x/raw carry no float dependence).
    counting = idx >> M
    x_tilde = 0
    for i in range(t):
        x_tilde = (x_tilde << 1) | ((counting >> i) & 1)
    return QPEResult(x=_negate_readout(x_tilde, t), t=t, raw=x_tilde)


def _blend_fn(rdtype, _cache: dict = {}) -> Callable:
    """One semiclassical QPE step given the circuit-applied branch
    Uw = U^(2^j) w: rotate by the deferred phase, fold the two branch
    weights, and collapse — the same closed form as the Shor oracle step
    (semiclassical.collapse_from_a1), with a generic U in place of the
    modular-multiply gather.

    The rotate/fold/probability numerics here MUST stay in lockstep with
    semiclassical._oracle_pass (which fuses the same algebra into its
    blockwise gather — it cannot be shared as code): the cdt upcast
    points, the s2 factors, and the phi recurrence are what the
    distribution-parity tests (test_qpe.py) pin against the full-register
    engine.  Touch both together.

    The deferred phase phi is a DEVICE scalar threaded through the calls
    (mirroring semiclassical._step_fn), so a t-step loop chains dispatches
    with NO host round-trips — bits/probabilities are fetched once at the
    end."""
    key = jnp.dtype(rdtype).name
    fn = _cache.get(key)
    if fn is not None:
        return fn
    cdt = _compute_dtype(rdtype)
    s2 = jnp.asarray(1.0 / math.sqrt(2.0), rdtype)

    def blend(w, Uw, phi, r, force):
        theta = (jnp.pi * phi).astype(cdt)
        ct, st = jnp.cos(theta), jnp.sin(theta)
        g = Uw * s2
        a1 = jnp.stack([ct * g[0] - st * g[1], st * g[0] + ct * g[1]]).astype(rdtype)
        a0 = w * s2
        b0 = (a0 + a1) * s2
        b1 = (a0 - a1) * s2
        p0 = jnp.sum(b0[0].astype(cdt) ** 2 + b0[1].astype(cdt) ** 2)
        p1 = jnp.sum(b1[0].astype(cdt) ** 2 + b1[1].astype(cdt) ** 2)
        bit, p_cond, out = collapse_from_a1(w, a1, p0, p1, r, force, rdtype, cdt)
        return bit, p_cond, out, (phi + bit.astype(cdt)) / 2

    fn = _cache[key] = jax.jit(blend, donate_argnums=(0,))
    return fn


def run_semiclassical_qpe(
    powers: Powers,
    t: int,
    M: int,
    key: jax.Array,
    dtype=jnp.complex64,
    prep: Circuit = (),
    forced_bits: Optional[Sequence[int]] = None,
) -> QPEResult:
    """Phase estimation with ONE reused control qubit: the work register
    (2, 2^M) is the whole device state, measured t times.

    ``powers(j)`` returns the UNCONTROLLED circuit of U^(2^j) on work
    qubits [0, M); step s applies exponent j = t-1-s, rotates the result
    by the classically-deferred phase, and measure-collapse-resets the
    implicit control (semiclassical.py module docstring — the identical
    algebra, with eng.run(powers(j)) in place of the oracle gather).
    The returned QPEResult carries the full SemiclassicalRecord (bits in
    measurement order, per-bit branch conditionals) in `.record`; the
    phase numerator follows the sign convention documented on QPEResult.
    ``forced_bits`` forces the RAW readout bits (measurement order), the
    distribution-parity test hook."""
    if t > 52:
        raise ValueError(f"t={t} > 52 exceeds the float64 phase mantissa (x / 2^t)")
    from quantumcomputer.algorithms.semiclassical import validate_forced_bits

    forced_bits = validate_forced_bits(forced_bits, t, "t")
    from quantumcomputer.sim.engine import Register, StateVectorEngine

    rdtype = sv.real_dtype_of(dtype)
    cdt = _compute_dtype(rdtype)
    eng = StateVectorEngine(Register(L=0, M=M), dtype=dtype)
    w = eng.run(tuple(prep)) if prep else eng.initial_state()
    blend = _blend_fn(rdtype)
    rs = jax.random.uniform(key, (t,), dtype=cdt)

    # phi lives on device (cdt scalar) so the whole t-step loop chains
    # dispatches without a single host sync; bits/probs fetch at the end.
    phi_d = jnp.asarray(0, cdt)
    bits_d: List[jax.Array] = []
    probs_d: List[jax.Array] = []
    for s in range(t):
        circ = tuple(powers(t - 1 - s))
        # eng.run DONATES its input state — feed it a copy, the blend
        # still needs w for the a0 branch.
        Uw = eng.run(circ, w + 0) if circ else w + 0
        force = -1 if forced_bits is None else int(forced_bits[s])
        bit_d, p_d, w, phi_d = blend(
            w, Uw, phi_d, rs[s], jnp.asarray(force, jnp.int32)
        )
        bits_d.append(bit_d)
        probs_d.append(p_d)
    bits = [int(b) for b in bits_d]
    probs = [float(p) for p in probs_d]
    rec = SemiclassicalRecord.from_bits(bits, probs)
    return QPEResult(
        x=_negate_readout(rec.x_tilde, t), t=t, raw=rec.x_tilde, record=rec
    )
