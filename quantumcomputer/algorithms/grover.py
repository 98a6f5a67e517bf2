"""Grover search on the generic gate engine.

The reference implements only Shor's algorithm, but its engine claims to
be a general state-vector simulator (qc_shor.c:513-565 builds arbitrary
1q/2q gates).  This module is the generality proof for the rebuild: a
complete second algorithm expressed purely in the circuit IR — H / X
layers plus the MCPHASE diagonal primitive (models/circuit.MCZ) — running
unchanged on the single-device engine (any dtype)
and on the sharded mesh engine.

Construction (standard amplitude amplification):

  * oracle for marked index k: conjugate MCZ(all qubits) with X on the
    qubits where k's bit is 0 — flips the phase of |k> alone;
  * diffusion: H^n X^n MCZ X^n H^n = 2|s><s| - 1 up to a global phase;
  * floor(pi/4 * sqrt(2^n)) iterations put the success probability at
    sin^2((2r+1) asin(2^{-n/2})) ~ 1 - O(2^{-n}).

Every piece is diagonal or a 1q layer, so nothing here materializes a
matrix; on the mesh the MCZ's global control bits resolve to per-device
scalar conditions (communication-free, parallel/sharded.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax

from quantumcomputer.models.circuit import Circuit, Gate, H, MCZ, X


def grover_iterations(n: int) -> int:
    """The optimal iteration count floor(pi/4 * sqrt(2^n)) (>= 1)."""
    return max(1, int(math.floor(math.pi / 4.0 * math.sqrt(float(1 << n)))))


def grover_circuit(n: int, marked: int, iterations: Optional[int] = None) -> Circuit:
    """The full search circuit over qubits 0..n-1 for one marked index."""
    if not (0 <= marked < (1 << n)):
        raise ValueError(f"marked index {marked} outside [0, 2^{n})")
    if n < 2:
        raise ValueError("Grover needs n >= 2 (at n=1 one iteration overshoots)")
    iters = grover_iterations(n) if iterations is None else int(iterations)
    qs = range(n)
    zeros = [q for q in qs if not (marked >> q) & 1]
    gates: list = [H(q) for q in qs]
    for _ in range(iters):
        # Oracle: phase-flip |marked>.
        gates += [X(q) for q in zeros]
        gates.append(MCZ(*qs))
        gates += [X(q) for q in zeros]
        # Diffusion about the uniform superposition.
        gates += [H(q) for q in qs]
        gates += [X(q) for q in qs]
        gates.append(MCZ(*qs))
        gates += [X(q) for q in qs]
        gates += [H(q) for q in qs]
    return tuple(gates)


def grover_search(
    n: int,
    marked: int,
    key: jax.Array,
    engine=None,
    iterations: Optional[int] = None,
) -> Tuple[int, float]:
    """Run the search and measure once: (measured index, success prob).

    `engine` is any engine with run/measure semantics (StateVectorEngine or
    ShardedStateVectorEngine); default is a complex64 single-chip engine.
    The returned probability is the pre-measurement |<marked|psi>|^2 —
    the quantity the theory bounds, independent of the one draw.
    """
    import jax.numpy as jnp

    if engine is None:
        from quantumcomputer.sim.engine import Register, StateVectorEngine

        engine = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    # The engines reset to the Shor convention |0..01> (qc_shor.c:318-324);
    # Grover is defined from |0..0> — start from zero_state(), which is
    # layout-proof (no reset-bit decoding).
    circ = grover_circuit(n, marked, iterations)
    state = engine.run(circ, engine.zero_state())
    amp = engine.to_numpy(state)[marked]
    p_success = float(abs(amp) ** 2)
    idx, _ = engine.measure(state, key)
    return int(idx), p_success
