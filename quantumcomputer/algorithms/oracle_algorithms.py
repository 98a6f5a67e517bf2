"""Textbook phase-oracle algorithms: Bernstein-Vazirani and Deutsch-Jozsa.

Beyond the reference's scope (qc_shor.c implements only Shor) — included
as the simplest whole-stack determinism checks of the generic layer: both
algorithms are H^n / phase-oracle / H^n sandwiches whose single
measurement is DETERMINISTIC on an ideal simulator, so any engine or
dtype that runs them must return the exact hidden string / verdict.

The phase oracles are products of Z gates (diagonal passes;
communication-free on the mesh), so these run unchanged on the
single-device and the sharded engine:

  * Bernstein-Vazirani: U_s|x> = (-1)^{s.x}|x> is exactly prod_{i: s_i=1}
    Z_i; the H-sandwich maps it to X^s, so the measurement reads s in ONE
    query (classically n queries).
  * Deutsch-Jozsa: f constant -> measure |0..0> with certainty; f
    balanced -> never |0..0>.  Balanced oracles here are the inner-product
    family f(x) = s.x (s != 0), the standard construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax

from quantumcomputer.models.circuit import Circuit, Gate, H, Z


def bv_oracle(n: int, s: int) -> List[Gate]:
    """Phase oracle U_s|x> = (-1)^{s.x}|x>: Z on every set bit of s."""
    if not (0 <= s < (1 << n)):
        raise ValueError(f"hidden string s={s} outside [0, 2^{n})")
    return [Z(q) for q in range(n) if (s >> q) & 1]


def bv_circuit(n: int, s: int) -> Circuit:
    """H^n . U_s . H^n from |0..0>: the full Bernstein-Vazirani circuit."""
    hs = [H(q) for q in range(n)]
    return tuple(hs + bv_oracle(n, s) + hs)


def _run_and_read(n: int, circ: Circuit, key, engine, dtype):
    import jax.numpy as jnp

    if engine is None:
        from quantumcomputer.sim.engine import Register, StateVectorEngine

        engine = StateVectorEngine(
            Register(L=n, M=0), dtype=jnp.complex64 if dtype is None else dtype
        )
    state = engine.run(circ, engine.zero_state())
    idx, _ = engine.measure(state, key)
    to_logical = getattr(engine, "logical_index", None)
    return int(idx) if to_logical is None else to_logical(int(idx))


def bernstein_vazirani(
    n: int, s: int, key: Optional[jax.Array] = None, engine=None, dtype=None
) -> int:
    """Recover the hidden string s in ONE oracle query; the returned index
    equals s with certainty on an ideal simulator (any engine/dtype)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    return _run_and_read(n, bv_circuit(n, s), key, engine, dtype)


def deutsch_jozsa(
    n: int,
    oracle: Sequence[Gate],
    key: Optional[jax.Array] = None,
    engine=None,
    dtype=None,
) -> bool:
    """True iff the phase oracle implements a CONSTANT function.

    `oracle` is any diagonal +-1 phase oracle on qubits [0, n) (e.g.
    `bv_oracle(n, s)` with s != 0 for the balanced inner-product family,
    or `[]` for the constant function).  Ideal-simulator contract:
    constant -> the measurement is |0..0> with certainty; balanced ->
    |0..0> has amplitude exactly 0."""
    if key is None:
        key = jax.random.PRNGKey(0)
    hs = [H(q) for q in range(n)]
    idx = _run_and_read(n, tuple(hs + list(oracle) + hs), key, engine, dtype)
    return idx == 0
