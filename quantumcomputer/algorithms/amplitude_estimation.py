"""Quantum amplitude estimation: QPE on the Grover iterate.

The composition proof for the algorithm layer: the Grover iterate
(algorithms/grover.py) fed to the generic phase-estimation driver
(algorithms/qpe.py) estimates the amplitude a = |marked| / 2^n
quadratically faster than sampling (Brassard-Hoyer-Mosca-Tapp 2000).
Everything is circuit IR — it runs on any engine the framework has.

Exact algebra (no global-phase hand-waving): with O the exact phase-flip
diagonal of the marked set and D = H^n X^n MCZ X^n H^n, the matrix D is
exactly -(2|s><s| - I) — the MCZ's -1 at |0..0> is part of its matrix,
not a dropped global phase.  So the iterate built here is Q = D O =
-G_std, where G_std = (2|s><s| - I) O has eigenvalues e^{+-2i theta_a},
sin^2(theta_a) = a.  Q's eigenphases in turns are therefore
1/2 +- theta_a / pi, and the estimate inverts that:

    theta_hat = pi * |x / 2^t - 1/2|,   a_hat = sin^2(theta_hat).

A controlled iterate needs controls ONLY on the two MCZs: for any V
acting on qubits disjoint from the control, c-(V A V^dag) = V (c-A)
V^dag — conjugating layers (H/X) stay uncontrolled, and c-MCZ is just
MCPHASE with one more control qubit.  This keeps the controlled circuit
diagonal-or-1q-layer structured, exactly like Grover itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import jax

from quantumcomputer.algorithms.qpe import QPEResult, estimate_phase
from quantumcomputer.models.circuit import Gate, H, MCPHASE, X


def _controlled_grover_iterate(n: int, marked: Sequence[int], control: int) -> List[Gate]:
    """c-Q for one Grover iterate Q = D O on work qubits 0..n-1.

    O = product of phase flips of the marked indices; D the MCZ diffusion
    (grover.py construction).  Only the MCZs carry the extra control."""
    qs = tuple(range(n))
    gates: List[Gate] = []
    for k in marked:
        zeros = [q for q in qs if not (k >> q) & 1]
        gates += [X(q) for q in zeros]
        gates.append(MCPHASE(qs + (control,), math.pi))
        gates += [X(q) for q in zeros]
    gates += [H(q) for q in qs]
    gates += [X(q) for q in qs]
    gates.append(MCPHASE(qs + (control,), math.pi))
    gates += [X(q) for q in qs]
    gates += [H(q) for q in qs]
    return gates


@dataclass
class AmplitudeEstimate:
    """a_hat = sin^2(pi * |phase - 1/2|); error <= pi/2^t * (2 sqrt(a) + pi/2^t)
    with probability >= 8/pi^2 (BHMT theorem 12)."""

    a_hat: float
    qpe: QPEResult


def amplitude_estimate(
    n: int,
    marked: Sequence[int],
    t: int,
    key: jax.Array,
    engine=None,
    dtype=None,
) -> AmplitudeEstimate:
    """Estimate a = len(marked) / 2^n with t counting bits.

    `engine` must span Register(L=t, M=n) if supplied (single-chip or
    mesh); default is a complex64 single-chip engine.  The work register
    is prepared in the uniform superposition (H^n from |0..0>, correcting
    the engine's |0..01> reset), the eigenbasis mix that makes QPE land on
    +-theta_a with equal weight — either sign inverts to the same a_hat."""
    marked = sorted(set(int(k) for k in marked))
    if not marked:
        raise ValueError("marked set is empty (a = 0 has no phase to estimate)")
    if not all(0 <= k < (1 << n) for k in marked):
        raise ValueError(f"marked indices {marked} outside [0, 2^{n})")
    if len(marked) == (1 << n):
        raise ValueError("all indices marked (a = 1): theta_a = pi/2 needs no estimation")

    def controlled_powers(j, control):
        # Q^(2^j) = the controlled iterate repeated 2^j times (Q's order is
        # generally irrational — no shortcut like modexp's square chain).
        return _controlled_grover_iterate(n, marked, control) * (1 << j)

    if engine is None:
        import jax.numpy as jnp

        from quantumcomputer.sim.engine import Register, StateVectorEngine

        engine = StateVectorEngine(
            Register(L=t, M=n), dtype=jnp.complex64 if dtype is None else dtype
        )
    # Uniform superposition from the engine's |0..01> reset (grover.py):
    # X the set reset bits back to |0..0>, then H^n.
    r0 = int(getattr(engine, "reset_index", 1))
    prep = tuple(X(q) for q in range(n) if (r0 >> q) & 1) + tuple(H(q) for q in range(n))
    res = estimate_phase(controlled_powers, t, n, key, engine=engine, prep=prep)
    theta = math.pi * abs(res.phase - 0.5)
    return AmplitudeEstimate(a_hat=math.sin(theta) ** 2, qpe=res)
