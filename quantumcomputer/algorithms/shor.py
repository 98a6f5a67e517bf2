"""Shor's algorithm driver: classical orchestration around the quantum core.

Reproduces shors_algorithm / find_period (qc_shor.c:912-1134) with typed
results instead of the reference's ErrorCode enum (qc_shor.c:164-170), and
with its latent bugs fixed (see SURVEY.md §4):

  * period-found flag is explicit, never uninitialized (qc_shor.c:915);
  * the a^(p/2) ≡ -1 (mod C) validity check uses the *current* trial
    integer (the reference tests forced_trial_int — always 0 — in the trial
    loop, qc_shor.c:1091, disabling the check);
  * all power tests use exact modular exponentiation, not double pow();
  * trial integers sharing a factor with C are resolved classically via
    gcd (textbook Shor) rather than running a non-unitary "permutation"
    gate, which is what the reference would silently do.

The no-remeasure semantic is kept: every attempt re-runs the circuit from
the reset register (qc_shor.c:299-301, 922); collapsed states are never
re-sampled.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from quantumcomputer.algorithms import number_theory as nt
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.sim.engine import Register, StateVectorEngine
from quantumcomputer.utils.logging import get_logger, ui_active, verbosity

log = get_logger("shor")


class Outcome(Enum):
    OK = "ok"
    PERIOD_NOT_FOUND = "period_not_found"
    TRIVIAL_FACTORS = "trivial_factors"
    BAD_ARGUMENTS = "bad_arguments"


@dataclass
class AttemptRecord:
    """One period-finding attempt: measured index, omega, candidate period."""

    a: int
    measured_index: int
    omega: float
    period: Optional[int]
    valid: bool
    reason: str = ""
    #: wall-clock of this attempt's quantum step + classical post-processing.
    #: The reference times only the whole algorithm (qc_shor.c:1007-1013,
    #: 1056-1063, reproduced as ShorResult.elapsed_s and the -v print);
    #: per-attempt timing is a beyond-reference observability surface.
    elapsed_s: float = 0.0


@dataclass
class ShorResult:
    outcome: Outcome
    C: int
    factors: Optional[Tuple[int, int]] = None
    period: Optional[int] = None
    a: Optional[int] = None
    attempts: List[AttemptRecord] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.outcome is Outcome.OK


def read_omega(state_num: int, L: int, M: int) -> float:
    """Bit-reversed L-register readout: omega = x_tilde / 2^L
    (qc_shor.c:868-883)."""
    x_tilde = 0
    power = 0
    for i in range(L + M - 1, M - 1, -1):
        x_tilde += ((state_num >> i) & 1) << power
        power += 1
    return x_tilde / float(1 << L)


def issue_warnings(C: int, L: int, M: int) -> List[str]:
    """Register-size confidence warnings (qc_shor.c:340-351)."""
    warnings = []
    if (1 << M) < C:
        warnings.append(
            f"M register too small for reliable results: ensure 2^M >= C (minimum M = {nt.min_M_for(C)})"
        )
    if (1 << L) < C * C:
        warnings.append(
            f"L register too small for full period confidence: ensure 2^L >= C^2 (suggested L = {nt.recommended_L_for(C)})"
        )
    # Beyond the reference's warnings: a prime (or even) C can never yield
    # nontrivial odd factors — say so up front instead of letting the
    # trial loop exhaust itself (the run still proceeds, like the
    # reference's warn-and-continue convention).
    if C > 2 and C % 2 == 0:
        warnings.append(f"C = {C} is even: factor 2 directly; Shor needs an odd composite")
    elif C < (1 << 20) and nt.is_prime(C):
        warnings.append(f"C = {C} is prime: no nontrivial factors exist")
    return warnings


def find_period(
    engine: StateVectorEngine,
    C: int,
    a: int,
    key: jax.Array,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    allow_template: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_segment_gates: int = 8,
) -> AttemptRecord:
    """One quantum period-finding attempt (find_period, qc_shor.c:912-964):
    reset -> circuit -> measure -> omega -> continued fractions -> period test.

    checkpoint_dir: preemption recovery for long runs (SURVEY.md §5) — the
    circuit executes in segments of `checkpoint_segment_gates` gates with a
    snapshot after each (sim/checkpoint.run_with_checkpoints); a killed
    process resumes from the last valid snapshot on the next call.  Only
    pre-measurement states are ever snapshotted: measurement itself always
    runs fresh (the reference's no-remeasure semantic, qc_shor.c:299-301).
    Costs state-passing programs (two state buffers live), so it is not
    available at the single-chip memory ceiling."""
    reg = engine.register

    def static_circuit():
        if getattr(engine, "layout", "standard") == "m_high":
            from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

            return shor_circuit_mhigh(C, a, reg.L, reg.M)
        return shor_circuit(C, a, reg.L, reg.M)

    _, very_verbose = verbosity()
    if very_verbose and checkpoint_dir is not None:
        # Checkpointing wins over per-phase progress: -V would otherwise
        # silently skip run_with_checkpoints and a preempted multi-hour run
        # would restart from gate 0 (reviewer r3 finding).
        print(
            "      - (checkpointing enabled: per-phase -V progress is "
            "replaced by per-segment snapshots)"
        )
        very_verbose = False
    ceiling_progress = False
    if very_verbose:
        # The per-phase progress path threads state-PASSING programs (input
        # + output state live) and a donating measure — two state buffers.
        # At the single-device memory ceiling only reset-folded
        # scalar-output forms fit, so -V switches to folded
        # PREFIX programs there: each phase boundary runs reset->prefix->
        # norm as one one-state-program (recomputing earlier phases — the
        # price of progress lines at a size where a second state buffer
        # cannot exist), then the measurement runs the usual folded
        # scalar-output program.
        from quantumcomputer.sim.engine import (
            compute_plane_dtype,
            two_state_programs_fit,
        )

        n_local = reg.n - getattr(engine, "d", 0)
        # dd64 states carry FOUR f32 planes (hi/lo pairs) — twice the bytes
        # of a complex f32 state; count them as one extra qubit so the
        # ceiling path is chosen where the state-passing form cannot fit.
        n_eff = n_local + (1 if getattr(engine, "dtype", None) == "dd64" else 0)
        ceiling_progress = not two_state_programs_fit(
            n_eff, compute_plane_dtype(engine.real_dtype)
        )
    if very_verbose and ceiling_progress:
        circuit = static_circuit()
        L = reg.L
        print("      - Performing quantum computation...")
        print(
            "      - (memory ceiling: progress via reset-folded prefix "
            "programs — one state buffer live, earlier phases recomputed)"
        )
        banners = (
            "         - Applying Hadamard matrices.",
            "         - Applying a^x mod (C) gates.",
            "         - Performing inverse quantum Fourier transform.",
        )
        for k, banner in enumerate(banners, start=1):
            print(banner)
            if k == len(banners):
                # The final phase is executed BY the folded measurement
                # program right below — a third run_norm would run the full
                # circuit twice back to back (reviewer r3 finding).
                break
            # Blocking scalar fetch = true execution barrier; the fetched
            # norm doubles as the Report §IV.A conservation check.
            norm = engine.run_norm(tuple(circuit[: k * L]))
            log.debug("phase %d/3 norm %.12f", k, norm)
        print("      - Measuring state...")
        if hasattr(engine, "run_and_measure_index"):
            idx = engine.run_and_measure_index(circuit, key)
        else:
            idx, _ = engine.run_and_measure(circuit, key)
    elif very_verbose:
        circuit = static_circuit()
        # Reference -V progress surface (qc_shor.c:918-932, 716-735): run
        # the three circuit phases as separate programs with a blocking norm
        # fetch after each, so the progress lines reflect real execution
        # (dispatch alone is async).  Both circuit forms are laid out as
        # [H layer | modexp ladder | iQFT], L gates per phase.
        print("      - Performing quantum computation...")
        L = reg.L
        phases = (
            ("         - Applying Hadamard matrices.", circuit[:L]),
            ("         - Applying a^x mod (C) gates.", circuit[L : 2 * L]),
            ("         - Performing inverse quantum Fourier transform.", circuit[2 * L :]),
        )
        state = None
        for banner, phase in phases:
            print(banner)
            state = engine.run(tuple(phase), state)
            engine.norm(state)  # host fetch = true execution barrier
        print("      - Measuring state...")
        idx, _ = engine.measure(state, key)
    elif checkpoint_dir is not None:
        import os
        import shutil

        from quantumcomputer.sim.checkpoint import run_with_checkpoints

        # Per-(C, a) subdirectory: the trial loop runs different circuits,
        # and a stale higher-numbered snapshot from another `a` would shadow
        # this attempt's progress (the fingerprint guard would reject it and
        # force a cold start).
        attempt_dir = os.path.join(checkpoint_dir, f"C{C}_a{a}")
        state = run_with_checkpoints(
            engine, static_circuit(), attempt_dir,
            segment_gates=checkpoint_segment_gates,
        )
        idx, _ = engine.measure(state, key)  # fresh measurement, never replayed
        shutil.rmtree(attempt_dir, ignore_errors=True)  # attempt complete
    else:
        # Reset -> circuit -> measure, one compiled program (qc_shor.c:922-928).
        # Only the measured index is fetched: the collapse is dead code (the
        # reference discards the collapsed state too), which keeps the
        # program at ONE state buffer plus the gates' own temporaries.
        # Template form (multi-`a` trial loops only): the oracle permutation
        # tables are program OPERANDS, so the loop compiles ONE program per
        # (L, M) instead of one per trial integer — each extra `a` would
        # otherwise cost a fresh XLA compile for a milliseconds-long
        # execution.  The slot oracle gathers through a runtime table
        # operand, so it needs TWO state buffers (skipped at the
        # single-device memory ceiling); forced single-`a` runs keep the
        # static form, whose indices XLA folds into the program.
        use_template = allow_template and hasattr(engine, "run_and_measure_index_with_tables")
        if getattr(engine, "strict_reference", False):
            # Template tables build unitary inverse permutations, which the
            # warn-and-wrap mode may not have (2^M < C); static circuits only.
            use_template = False
        if use_template:
            from quantumcomputer.sim.engine import (
                compute_plane_dtype,
                two_state_programs_fit,
            )

            # Memory gate is PER DEVICE: a sharded engine holds 2^(n-d)
            # amplitudes per device, so large-n mesh runs still template.
            # Gate on the COMPUTE dtype: every gate upcasts bf16 to f32, so
            # a 'complex32' template program really peaks at two f32 states.
            n_local = reg.n - getattr(engine, "d", 0)
            use_template = two_state_programs_fit(
                n_local, compute_plane_dtype(engine.real_dtype)
            )
        if use_template:
            from quantumcomputer.models.shor_circuit import (
                shor_circuit_template,
                shor_oracle_tables,
            )

            layout = getattr(engine, "layout", "standard")
            template = shor_circuit_template(reg.L, reg.M, layout)
            tables = shor_oracle_tables(C, a, reg.L, reg.M)
            d = getattr(engine, "d", 0)
            if layout == "m_high" and 0 < d <= reg.M:
                # Mesh m_high: bind packed routing operands so the
                # compile-once template keeps the packed ~(D-1)/D-shard
                # ICI volume instead of the D-round rotation fallback
                # (parallel/sharded.packed_slot_routes).
                from quantumcomputer.parallel.sharded import packed_slot_routes

                routes = packed_slot_routes(C, a, reg.L, reg.M, d)
                idx = engine.run_and_measure_index_with_tables(template, tables, key, routes=routes)
            else:
                idx = engine.run_and_measure_index_with_tables(template, tables, key)
        elif hasattr(engine, "run_and_measure_index"):
            idx = engine.run_and_measure_index(static_circuit(), key)
        else:
            idx, _ = engine.run_and_measure(static_circuit(), key)
    if getattr(engine, "layout", "standard") == "m_high":
        idx = engine.logical_index(idx)
    omega = read_omega(idx, reg.L, reg.M)
    if very_verbose:
        print("      - Using continued fractions to guess period...")
    period = nt.find_period_from_omega(omega, a, C, num_fractions, trials_per_denominator)
    log.debug("a=%d measured index=%d omega=%.6f period=%s", a, idx, omega, period)
    return AttemptRecord(a=a, measured_index=idx, omega=omega, period=period, valid=period is not None)


def _validate_and_factor(C: int, a: int, period: int) -> Tuple[bool, str, Optional[Tuple[int, int]]]:
    """Validity ladder (qc_shor.c:1030-1050): period even, a^(p/2) != -1 mod C;
    then factors = gcd(a^(p/2) +- 1, C), rejecting trivial ones."""
    if period % 2 != 0:
        return False, "period is odd", None
    half = nt.modpow(a, period // 2, C)
    if half == C - 1:
        return False, "a^(p/2) == -1 (mod C)", None
    f0 = nt.gcd(half + 1, C)
    f1 = nt.gcd(half - 1, C)
    if f0 == 1 or f1 == 1 or f0 == C or f1 == C:
        return False, "trivial factors", None
    return True, "", (max(f0, f1), min(f0, f1))


def shors_algorithm(
    C: int,
    L: int,
    M: int,
    forced_trial_int: int = 0,
    seed: Optional[int] = None,
    dtype=jnp.complex64,
    max_attempts_per_a: int = 1,
    engine: Optional[StateVectorEngine] = None,
    mesh=None,
    num_fractions: int = nt.NUM_CONTINUED_FRACTIONS,
    trials_per_denominator: int = nt.TRIALS_PER_DENOMINATOR,
    layout: str = "standard",
    checkpoint_dir: Optional[str] = None,
    strict_reference: bool = False,
    semiclassical: bool = False,
) -> ShorResult:
    """Full Shor driver (qc_shor.c:1003-1134).

    forced_trial_int != 0 -> single attempt with that a; otherwise loop
    a = 2 .. C-2 until non-trivial factors emerge.  Seeded jax.random
    replaces the reference's time-seeded MT19937 (qc_shor.c:1296-1299);
    pass seed=None for wall-clock seeding like the reference.

    Passing a jax.sharding.Mesh runs the circuit on the distributed engine
    (state sharded over the mesh; see parallel/sharded.py).

    semiclassical=True replaces the L counting qubits with ONE reused,
    sequentially-measured qubit (Griffiths-Niu semiclassical iQFT; see
    algorithms/semiclassical.py): the state shrinks from 2^(L+M) to
    2^M amplitudes (the control qubit is implicit) with an IDENTICAL
    outcome distribution.  With a mesh the work register is sharded
    (parallel/sharded_semiclassical.py) and the modulus ceiling grows
    with device count (M up to 30); dtype='complex32' halves storage,
    per-step memory traffic, and exchange bytes.
    """
    if C < 4 or L < 1 or M < 1:
        return ShorResult(outcome=Outcome.BAD_ARGUMENTS, C=C)
    if semiclassical:
        if engine is not None or layout != "standard" or strict_reference:
            raise ValueError(
                "semiclassical mode is its own engine: no layout/"
                "strict_reference/engine arguments (mesh= shards the work "
                "register, parallel/sharded_semiclassical.py)"
            )
        if isinstance(dtype, str) and dtype not in ("complex32", "c32", "dd64"):
            # complex32 = bf16 planar storage with f32 angle/probability
            # arithmetic (real_dtype_of handles the string); dd64 routes to
            # the host-synchronous parity driver (semiclassical_dd.py).
            raise ValueError(
                "semiclassical mode supports complex32/complex64/complex128/dd64"
            )
        if isinstance(dtype, str) and dtype == "dd64" and mesh is not None:
            raise ValueError(
                "dd64 semiclassical is single-chip (parity mode); use "
                "complex32/complex64 on a mesh"
            )
    if engine is not None and strict_reference and not getattr(engine, "strict_reference", False):
        # A caller-supplied engine carries its own oracle semantics; silently
        # ignoring the flag would fake a bug-compat comparison (reviewer r3).
        raise ValueError(
            "strict_reference=True conflicts with the provided engine "
            "(construct it with StateVectorEngine(strict_reference=True))"
        )
    if semiclassical:
        # No full-register engine exists in this mode: the (M+1)-qubit step
        # program lives in algorithms/semiclassical.py, and L+M can far
        # exceed any chip's state budget (that is the point).
        pass
    elif engine is None:
        if isinstance(dtype, str) and dtype == "dd64":
            # Double-float parity mode: f64-equivalent accuracy from f32
            # arithmetic (sim/dd_engine.py; sharded_dd.py on a mesh).
            if layout != "standard":
                raise ValueError("dd64 parity mode uses the standard layout")
            if mesh is not None:
                from quantumcomputer.parallel.sharded_dd import (
                    ShardedDDStateVectorEngine,
                )

                engine = ShardedDDStateVectorEngine(Register(L=L, M=M), mesh=mesh)
            else:
                from quantumcomputer.sim.dd_engine import DDStateVectorEngine

                engine = DDStateVectorEngine(Register(L=L, M=M))
        else:
            if mesh is not None:
                if strict_reference:
                    raise ValueError("strict_reference mode is single-chip (no mesh support)")
                from quantumcomputer.parallel.sharded import ShardedStateVectorEngine

                engine = ShardedStateVectorEngine(
                    Register(L=L, M=M), dtype=dtype, mesh=mesh, layout=layout
                )
            else:
                engine = StateVectorEngine(
                    Register(L=L, M=M), dtype=dtype, layout=layout,
                    strict_reference=strict_reference,
                )
    if seed is None:
        seed = int(time.time_ns() % (1 << 31))
    key = jax.random.PRNGKey(seed)

    start = time.perf_counter()
    result = ShorResult(outcome=Outcome.PERIOD_NOT_FOUND, C=C)

    forced = bool(forced_trial_int)
    verbose, _ = verbosity()
    # Reference -v attempt surface (qc_shor.c:1019-1063, 1072-1120): the
    # trailing blank line is loop-path only, like the reference's "\n\n"s.
    tail = "" if forced else "\n"
    trial_ints = [forced_trial_int] if forced else list(range(2, C - 1))
    for a in trial_ints:
        if verbose:
            kind = "Forced trial integer" if forced else "Trial integer"
            print(f" --- {kind} a = {a}, finding period ...")
        g = nt.gcd(a, C)
        if g not in (1, C):
            # a shares a factor with C: the factorization is classical, and
            # the modular-multiply gate would not be unitary (SURVEY.md §7).
            log.info("gcd(%d, %d) = %d > 1: classical factor found", a, C, g)
            result.outcome = Outcome.OK
            result.factors = (max(g, C // g), min(g, C // g))
            result.a = a
            break
        found = False
        for _ in range(max_attempts_per_a):
            key, sub = jax.random.split(key)
            t_attempt = time.perf_counter()
            if semiclassical:
                from quantumcomputer.algorithms.semiclassical import (
                    find_period_semiclassical,
                )

                period, screc = find_period_semiclassical(
                    C, a, L, M, sub, dtype=dtype,
                    num_fractions=num_fractions,
                    trials_per_denominator=trials_per_denominator,
                    mesh=mesh, checkpoint_dir=checkpoint_dir,
                )
                # measured_index records x~ (the sequential bit readout);
                # there is no full-register basis index in this mode.
                attempt = AttemptRecord(
                    a=a, measured_index=screc.x_tilde, omega=screc.omega,
                    period=period, valid=period is not None,
                )
            else:
                attempt = find_period(
                    engine, C, a, sub, num_fractions, trials_per_denominator,
                    allow_template=not forced and checkpoint_dir is None,
                    checkpoint_dir=checkpoint_dir,
                )
            attempt.elapsed_s = time.perf_counter() - t_attempt
            log.info("attempt a=%d took %.6fs", a, attempt.elapsed_s)
            result.attempts.append(attempt)
            if attempt.period is None:
                if verbose and not forced:
                    print(f" --- A valid period could not be found for a = {a}.{tail}")
                log.debug("a=%d: no valid period from omega=%.4f", a, attempt.omega)
                continue
            ok, reason, factors = _validate_and_factor(C, a, attempt.period)
            attempt.valid = ok
            attempt.reason = reason
            if not ok:
                if reason == "trivial factors":
                    # A valid period was found but yielded only trivial
                    # factors — distinguish from never finding a period.
                    result.outcome = Outcome.TRIVIAL_FACTORS
                    # The reference prints these unconditionally
                    # (qc_shor.c:1052/1107); gate on CLI context so library
                    # callers keep a clean stdout.
                    if ui_active():
                        if forced:
                            print(" --- The factors found are trivial, consider trying a different trial integer.")
                        else:
                            print(" --- Factors found are trivial. Continuing to find non-trivial factors.")
                elif verbose:
                    print(f" --- Period was found to be {attempt.period}, but it did not pass the validity requirements.{tail}")
                log.debug("a=%d: period %d rejected (%s)", a, attempt.period, reason)
                continue
            if verbose:
                print(
                    f" --- A valid period = {attempt.period} has been found so the factors of "
                    f"C = {C} have been found quantum mechanically.\n"
                )
            result.outcome = Outcome.OK
            result.factors = factors
            result.period = attempt.period
            result.a = a
            found = True
            break
        if found:
            break

    result.elapsed_s = time.perf_counter() - start
    return result
