"""Quantum Volume: random SU(4) model circuits + heavy-output sampling.

The standard whole-stack stress test of a *generic* gate engine (Cross,
Bishop, Smolin, Gambetta, arXiv:1811.12926): a depth-m circuit on m qubits
whose every layer pairs the qubits at random and applies an independent
Haar-random SU(4) to each pair, then the heavy-output probability (HOP) of
sampled bitstrings is compared against the 2/3 pass threshold.

This is beyond the reference program's scope (qc_shor.c implements only
Shor's algorithm) and exists here because it exercises exactly the paths
the generic framework advertises: dense ``u2q`` gates across every
qubit stride pair (ops/gates.apply_2q), all-to-all connectivity (layer permutations cost
nothing in a state-vector simulator — the SU(4)s are simply applied to the
permuted pairs), and the hierarchical no-collapse sampler
(``engine.sample``).  On an ideal (noiseless) simulator the measured HOP
estimates the ideal heavy-output weight (~0.85 asymptotically), so the
test must pass at every m the chip can hold — a differential check of the
whole gate/measure stack against the complex128 NumPy oracle
(sim/reference.py), circuit by circuit.

Works on the single-chip engine and the sharded mesh engine alike (any
object with ``zero_state`` / ``run`` / ``sample``; physical indices are
mapped through ``logical_index`` when the engine defines one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.circuit import Circuit


def haar_su4(rng: np.random.Generator) -> np.ndarray:
    """Haar-random SU(4) via QR of a complex Ginibre matrix with the
    R-diagonal phase fix (Mezzadri, arXiv:math-ph/0609050)."""
    z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    q = q * (d / np.abs(d))
    # Fix the global phase into det == 1 (irrelevant to probabilities, but
    # makes the gate an honest SU(4) and the tests' unitarity check tight).
    return q / np.linalg.det(q) ** 0.25


def qv_model_circuit(m: int, rng: np.random.Generator, depth: Optional[int] = None) -> Circuit:
    """One QV model circuit on qubits [0, m): `depth` (default m) layers,
    each a random pairing of the qubits with an independent Haar-random
    SU(4) per pair (odd qubit counts idle one qubit per layer)."""
    if m < 2:
        raise ValueError("quantum volume needs m >= 2 qubits")
    gates: list = []
    for _ in range(m if depth is None else depth):
        perm = rng.permutation(m)
        for i in range(m // 2):
            # Orientation is irrelevant under a Haar-random SU(4); fixing
            # q_hi > q_lo matches the oracle's convention directly.
            q_hi, q_lo = sorted((int(perm[2 * i]), int(perm[2 * i + 1])), reverse=True)
            gates.append(cir.U2Q(q_hi, q_lo, haar_su4(rng)))
    return tuple(gates)


def ideal_probabilities(circ: Circuit, m: int) -> np.ndarray:
    """Exact complex128 output distribution of `circ` from |0...0> via the
    NumPy parity oracle (sim/reference.py) — the trusted side of the
    differential: never touches the engine under test."""
    from quantumcomputer.sim import reference as ref

    psi = np.zeros(1 << m, dtype=np.complex128)
    psi[0] = 1.0
    for g in circ:
        if g.name != "u2q":
            raise ValueError(f"QV circuits contain only u2q gates, got {g.name}")
        psi = ref.apply_2q(psi, np.array(g.matrix, dtype=np.complex128), *g.qubits)
    return np.abs(psi) ** 2


def heavy_set(probs: np.ndarray) -> np.ndarray:
    """Boolean mask of the heavy outputs: ideal probability strictly above
    the MEDIAN ideal probability (the paper's definition)."""
    return probs > np.median(probs)


@dataclass
class QVResult:
    m: int
    num_circuits: int
    shots: int
    hops: List[float]          # measured heavy-output probability per circuit
    ideal_hops: List[float]    # ideal heavy-output weight per circuit
    mean_hop: float
    lower_2sigma: float        # mean - 2*sqrt(p(1-p)/num_circuits), the paper's bound
    passed: bool               # lower_2sigma > 2/3
    quantum_volume: int        # 2^m if passed else 0

    def to_dict(self) -> dict:
        return {
            "m": self.m, "num_circuits": self.num_circuits, "shots": self.shots,
            "mean_hop": self.mean_hop, "lower_2sigma": self.lower_2sigma,
            "passed": self.passed, "quantum_volume": self.quantum_volume,
        }


def run_quantum_volume(
    m: int,
    engine,
    *,
    num_circuits: int = 20,
    shots: int = 100,
    seed: int = 0,
    key=None,
) -> QVResult:
    """Run the full QV protocol at width m on `engine` and score it.

    The engine executes each model circuit from ``zero_state()`` and draws
    `shots` samples; the heavy set comes from the independent complex128
    oracle.  Pass criterion (the paper's): the 2-sigma lower confidence
    bound on the pooled HOP exceeds 2/3."""
    import jax

    if key is None:
        key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    to_logical = getattr(engine, "logical_index", None)

    hops: List[float] = []
    ideal: List[float] = []
    for c in range(num_circuits):
        circ = qv_model_circuit(m, rng)
        probs = ideal_probabilities(circ, m)
        heavy = heavy_set(probs)
        ideal.append(float(probs[heavy].sum()))

        state = engine.run(circ, engine.zero_state())
        key, sub = jax.random.split(key)
        samples = np.asarray(engine.sample(state, sub, shots))
        if to_logical is not None:
            samples = np.array([to_logical(int(s)) for s in samples])
        hops.append(float(np.mean(heavy[samples])))

    mean_hop = float(np.mean(hops))
    # The paper's confidence bound, nh - 2*sqrt(nh*(ns - nh/nc)), reduces
    # to sigma^2 = p(1-p)/nc on the pooled HOP: the unit of independence
    # is the CIRCUIT, not the shot (heavy weights vary circuit-to-circuit,
    # so shots within one circuit are correlated).  Dividing by nc*shots
    # would certify a pass ~sqrt(shots) too eagerly.
    sigma = float(np.sqrt(max(mean_hop * (1.0 - mean_hop), 1e-12) / num_circuits))
    lower = mean_hop - 2.0 * sigma
    passed = lower > 2.0 / 3.0
    return QVResult(
        m=m, num_circuits=num_circuits, shots=shots, hops=hops,
        ideal_hops=ideal, mean_hop=mean_hop, lower_2sigma=lower,
        passed=passed, quantum_volume=(1 << m) if passed else 0,
    )
