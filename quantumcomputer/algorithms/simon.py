"""Simon's hidden-subgroup algorithm: the quantum/classical loop that
prefigures Shor.

Beyond the reference's scope (qc_shor.c implements only Shor) — included
because it exercises a structurally DIFFERENT oracle than everything else
in the framework: a two-register XOR oracle |x>|y> -> |x>|y ^ f(x)>, here
realized as a pure CNOT network (no diagonals, no permutation gathers),
plus a classical GF(2) linear-algebra post-processing loop — the same
quantum-sample / classical-solve rhythm as Shor's continued fractions.

Construction.  For hidden string s != 0 pick k = lowest set bit of s and
f(x) = x ^ (x_k * s): linear over GF(2), 2-to-1 with collision pairs
{x, x ^ s} (flipping bit k of x toggles the mask), so it satisfies
Simon's promise exactly.  The oracle's CNOT list follows from linearity:
y_j ^= x_j for every j with s_j = 0; y_j ^= x_j ^ x_k for j != k with
s_j = 1; bit k itself cancels (x_k ^ x_k).  Each measurement of the
x-register after the H sandwich yields a uniformly random z with
z . s = 0 (mod 2); n - 1 independent equations determine s as the GF(2)
null-space vector.

Register convention: Register(L=n, M=n) — x is the counting register
(bits [n, 2n)), y the work register (bits [0, n)), matching the
framework's layout (sim/engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import jax

from quantumcomputer.models.circuit import CNOT, Circuit, H


def simon_oracle(n: int, s: int) -> List:
    """CNOT network of the standard linear Simon oracle for hidden s:
    |x>|y> -> |x>|y ^ f(x)> with f(x) = x ^ (x_k * s), k = lowest set bit
    of s.  x lives at bits [n, 2n), y at [0, n)."""
    if not (1 <= s < (1 << n)):
        raise ValueError(f"hidden string s={s} must be in [1, 2^{n}) (s=0 is trivial)")
    k = (s & -s).bit_length() - 1
    gates = []
    for j in range(n):
        if j == k:
            continue  # y_k ^= x_k ^ x_k: cancels
        gates.append(CNOT(n + j, j))
        if (s >> j) & 1:
            gates.append(CNOT(n + k, j))
    return gates


def simon_circuit(n: int, s: int) -> Circuit:
    """H^x . oracle . H^x from |0...0> (both registers zero)."""
    hx = [H(n + q) for q in range(n)]
    return tuple(hx + simon_oracle(n, s) + hx)


def _gf2_nullspace(rows: List[int], n: int) -> Optional[int]:
    """The unique nonzero null-space vector of an (n-1)-rank GF(2) row set,
    or None when rank < n-1.  Rows and the result are n-bit ints."""
    basis: List[int] = []
    pivots: List[int] = []
    for r in rows:
        for b, p in zip(basis, pivots):
            if (r >> p) & 1:
                r ^= b
        if r:
            p = r.bit_length() - 1
            basis.append(r)
            pivots.append(p)
    if len(basis) != n - 1:
        return None
    # Back-substitute to reduced row echelon, then read s off the free column.
    for i in range(len(basis)):
        for j in range(len(basis)):
            if i != j and (basis[j] >> pivots[i]) & 1:
                basis[j] ^= basis[i]
    free = next(p for p in range(n) if p not in pivots)
    s = 1 << free
    for b, p in zip(basis, pivots):
        if (b >> free) & 1:
            s |= 1 << p
    return s


@dataclass
class SimonResult:
    s: int                 # recovered hidden string
    rounds: int            # quantum samples consumed (z = 0 draws included)
    equations: List[int]   # the measured NONZERO z vectors (z . s = 0 for all)


def simon_search(
    n: int,
    s: int,
    key: Optional[jax.Array] = None,
    engine=None,
    dtype=None,
    max_rounds: int = 0,
) -> SimonResult:
    """Run Simon's algorithm end to end: sample z vectors (each orthogonal
    to s over GF(2)) until they span the (n-1)-dimensional complement,
    then solve for s classically.  Expected rounds ~ n + O(1); the default
    budget 4n + 12 makes a failure astronomically unlikely."""
    import jax.numpy as jnp

    if key is None:
        key = jax.random.PRNGKey(0)
    if engine is None:
        from quantumcomputer.sim.engine import Register, StateVectorEngine

        engine = StateVectorEngine(
            Register(L=n, M=n), dtype=jnp.complex64 if dtype is None else dtype
        )
    if max_rounds <= 0:
        max_rounds = 4 * n + 12
    circ = simon_circuit(n, s)
    to_logical = getattr(engine, "logical_index", None)
    zs: List[int] = []
    for rounds in range(1, max_rounds + 1):
        key, sub = jax.random.split(key)
        state = engine.run(circ, engine.zero_state())
        idx, _ = engine.measure(state, sub)
        idx = int(idx) if to_logical is None else to_logical(int(idx))
        z = (idx >> n) & ((1 << n) - 1)  # x-register readout
        assert bin(z & s).count("1") % 2 == 0, "sampled z not orthogonal to s"
        if not z:
            continue  # adds no equation — the solve could only repeat itself
        zs.append(z)
        got = _gf2_nullspace(zs, n)
        if got is not None:
            return SimonResult(s=got, rounds=rounds, equations=zs)
    raise RuntimeError(
        f"Simon sampling did not reach rank {n - 1} in {max_rounds} rounds "
        "(probability ~2^-rounds; re-run with a different key)"
    )
