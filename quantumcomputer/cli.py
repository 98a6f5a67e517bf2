"""Command-line interface: the reference's flag surface, plus device knobs.

Matches parse_command_line_args / main (qc_shor.c:1173-1348): mandatory
-C/-L/-M, optional -a (forced trial integer), -v / -V verbosity — with
validation actually enforced (the reference's C<=0 / L<=0 / M<=0 checks
are broken or non-fatal, qc_shor.c:1240-1253).  Added runtime-tunable
knobs the reference hard-codes at compile time (qc_shor.c:58-61):
continued-fraction depth, trials per denominator — plus dtype, layout,
device count and RNG seed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import jax.numpy as jnp

from quantumcomputer.algorithms import number_theory as nt
from quantumcomputer.algorithms.shor import Outcome, issue_warnings, shors_algorithm
from quantumcomputer.utils.logging import configure, get_logger

log = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quantumcomputer",
        description="JAX state-vector simulation of Shor's algorithm.",
    )
    p.add_argument("-C", type=int, required=True, help="number to factorise")
    p.add_argument("-L", type=int, required=True, help="size of the L (counting) register")
    p.add_argument("-M", type=int, required=True, help="size of the M (work) register")
    p.add_argument("-a", type=int, default=0, help="forced trial integer (0 = loop over all)")
    p.add_argument("-v", action="store_true", dest="verbose", help="medium verbosity")
    p.add_argument("-V", action="store_true", dest="very_verbose", help="high verbosity")
    p.add_argument("--seed", type=int, default=None, help="RNG seed (default: wall clock)")
    p.add_argument(
        "--dtype",
        choices=["complex64", "complex128", "complex32", "dd64"],
        default="complex64",
        help=(
            "amplitude precision: complex64 (default), complex32 "
            "(bf16 storage + f32 compute: half the bytes per pass; amplitude "
            "error a few bf16 ulps relative), complex128 (f64 parity), dd64 "
            "(double-float: f64-equivalent parity from f32 arithmetic)"
        ),
    )
    p.add_argument(
        "--devices",
        type=int,
        default=1,
        help="shard the state vector over this many devices (power of two)",
    )
    p.add_argument(
        "--layout",
        choices=["standard", "m_high"],
        default="standard",
        help="physical qubit layout (m_high: work register in top bits; whole-row oracle gather)",
    )
    p.add_argument("--fractions", type=int, default=nt.NUM_CONTINUED_FRACTIONS, help="continued-fraction depth")
    p.add_argument("--trials", type=int, default=nt.TRIALS_PER_DENOMINATOR, help="multiples tried per denominator")
    p.add_argument(
        "--semiclassical",
        action="store_true",
        help=(
            "one-control-qubit period finding (Griffiths-Niu semiclassical "
            "inverse QFT): the L counting qubits collapse to ONE reused, "
            "sequentially-measured qubit, kept implicit — the state is 2^M "
            "amplitudes instead of 2^(L+M), with an identical outcome "
            "distribution"
        ),
    )
    p.add_argument(
        "--strict-reference",
        action="store_true",
        help=(
            "reference bug-compatibility: run the modular-multiply gates "
            "with the reference's warn-and-wrap undersized-M semantics "
            "(non-unitary when 2^M < C; qc_shor.c:340-351,654) for "
            "side-by-side comparison runs; single device"
        ),
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help=(
            "snapshot the evolving state between circuit segments for "
            "preemption recovery; a killed run resumes from the last "
            "snapshot when re-invoked with the same arguments"
        ),
    )
    return p


def validate(args: argparse.Namespace) -> Optional[str]:
    if args.C <= 3:
        return "Number to be factorised C is invalid (must be > 3)."
    if args.dtype == "dd64" and args.layout != "standard":
        return "dd64 parity mode uses the standard layout."
    if args.semiclassical and (args.layout != "standard" or args.strict_reference):
        return (
            "semiclassical mode is its own engine: no layouts or "
            "strict-reference (complex32 and dd64 ARE supported; "
            "--devices N shards the work register)."
        )
    if args.semiclassical and args.dtype == "dd64" and args.devices > 1:
        return "dd64 semiclassical is single-chip (parity mode)."
    if args.semiclassical and args.dtype == "dd64" and args.checkpoint_dir:
        return "dd64 semiclassical has no checkpointing (parity mode)."
    if args.semiclassical and args.checkpoint_dir and args.devices > 1:
        return (
            "semiclassical checkpointing is single-chip only (the sharded "
            "attempt is one fused dispatch with no step boundary)."
        )
    if args.strict_reference and (
        args.devices > 1 or args.layout != "standard" or args.dtype in ("complex32", "dd64")
    ):
        return "strict-reference mode is single-device, standard layout, complex64/128."
    if args.L <= 0:
        return "L is invalid (must be positive)."
    if args.M <= 0:
        return "M is invalid (must be positive)."
    if args.a and not (1 < args.a < args.C - 1):
        return "Forced trial integer must satisfy 1 < a < C-1."
    if args.semiclassical:
        # The state is 2^M amplitudes regardless of L (the control qubit is
        # implicit): the full-register L+M bounds do not apply.  M must fit
        # the int32 index budget and L the float64 omega mantissa
        # (x_tilde / 2^L is exact to L <= 52).
        if args.M > 30:
            return "semiclassical work register M > 30 exceeds the int32 index budget."
        if (1 << args.M) < args.C:
            # run_semiclassical would raise the same fact as a ValueError;
            # catch it here for the clean 'Error:' exit every other bad
            # argument gets (no warn-and-wrap mode exists on this engine).
            return (
                f"semiclassical work register 2^M={1 << args.M} < C={args.C}: "
                "the modular-multiply gate is not unitary (M must satisfy 2^M >= C)."
            )
        if args.L > 52:
            return "semiclassical L > 52 exceeds the float64 omega mantissa (x_tilde / 2^L)."
        if args.C >= (1 << 30):
            # The on-device shift-add modular multiply keeps intermediates
            # < 2C: int32 bounds the MODULUS (ops/gates.modmul_onchip).
            return "semiclassical mode needs C < 2^30 (int32 shift-add modular arithmetic)."
        if args.devices > 1 and args.M - (args.devices.bit_length() - 1) < 1:
            return "semiclassical sharding needs M - log2(devices) >= 1 (no local work rows)."
        return None
    if args.L + args.M > 32:
        return "L + M > 32 qubits exceeds the index budget (the reference's own bound, qc_shor.c:68-73)."
    if (
        args.L + args.M - (args.devices.bit_length() - 1) > 31
        and args.dtype != "complex128"  # c128 enables x64: int64 indices
    ):
        return (
            "L + M > 31 qubits exceeds the int32 single-device index budget: "
            "shard with --devices so L + M - log2(devices) <= 31 "
            "(or use --dtype complex128, which enables 64-bit indices)."
        )
    if args.layout == "m_high" and args.devices > (1 << args.M):
        return "m_high sharding needs devices <= 2^M (global bits must fit in the work register)."
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    err = validate(args)
    if err:
        print(f"Error: {err}", file=sys.stderr)
        return 2

    configure(args.verbose, args.very_verbose)
    from quantumcomputer.utils.compile_cache import enable as enable_compile_cache

    enable_compile_cache()
    for w in issue_warnings(args.C, args.L, args.M):
        print(f" --- *WARNING* {w}")

    if args.dtype == "complex128":
        import jax

        jax.config.update("jax_enable_x64", True)

    mesh = None
    if args.devices > 1:
        from quantumcomputer.parallel.mesh import build_mesh

        try:
            mesh = build_mesh(num_devices=args.devices)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 2
        print(f" --- Sharding state vector over {mesh.devices.size} device(s).")

    print("\n --- Finding factors...\n")
    result = shors_algorithm(
        C=args.C,
        L=args.L,
        M=args.M,
        forced_trial_int=args.a,
        seed=args.seed,
        dtype={"complex128": jnp.complex128, "dd64": "dd64", "complex32": "complex32"}.get(
            args.dtype, jnp.complex64
        ),
        mesh=mesh,
        num_fractions=args.fractions,
        trials_per_denominator=args.trials,
        layout=args.layout,
        checkpoint_dir=args.checkpoint_dir,
        strict_reference=args.strict_reference,
        semiclassical=args.semiclassical,
    )

    if args.verbose:
        print(f" --- Time to run Shor's Algorithm: {result.elapsed_s:.6f}s.")

    if result.outcome is Outcome.OK and result.factors:
        f0, f1 = result.factors
        print(f" --- Factors of {args.C} found: ({f0}, {f1}).")
        # Divisibility, not f0*f1 == C: when C has more than two prime
        # factors the gcd pair need not multiply to C but is still correct
        # (the reference's C/f0 == f1 check, qc_shor.c:1337-1339, is too
        # strict for the same reason).
        if args.C % f0 != 0 or args.C % f1 != 0:
            print(" --- These factors are incorrect. Consider increasing register sizes as per the warnings.")
        elif f0 * f1 != args.C:
            print(f" --- Note: {args.C} has more than two prime factors; {args.C} = {f0} * {args.C // f0}.")
        return 0
    print(f" --- A valid period was not found and hence C = {args.C} could not be factorised.")
    return 3


if __name__ == "__main__":
    sys.exit(main())
