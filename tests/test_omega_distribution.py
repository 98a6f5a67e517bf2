"""Statistical oracle: the measured-omega histogram for factoring 15
(L=3, M=4, a=7) — the Report §IV.B / TABLE I experiment.

Theory (and Candela's published data): omega is (near-)uniform over the
period-4 harmonics {0, 1/4, 1/2, 3/4}.  With L=3 (2^L = 8 divisible by the
period 4) the distribution is exactly uniform, so each harmonic has
probability 1/4; we check both support and a binomial tolerance."""

import jax
import jax.numpy as jnp
import numpy as np

from quantumcomputer.algorithms.shor import read_omega
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim.engine import Register, StateVectorEngine

N_SAMPLES = 400


def test_omega_distribution_table_I():
    C, a, L, M = 15, 7, 3, 4
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    state = eng.run(shor_circuit(C, a, L, M))

    # Exact check first: the state's omega distribution itself.
    probs = np.asarray(eng.probabilities(state))
    omega_prob: dict[float, float] = {}
    for idx, p in enumerate(probs):
        if p > 1e-15:
            w = read_omega(idx, L, M)
            omega_prob[w] = omega_prob.get(w, 0.0) + float(p)
    assert set(omega_prob) == {0.0, 0.25, 0.5, 0.75}
    for w, p in omega_prob.items():
        assert abs(p - 0.25) < 1e-12, f"omega={w}: prob {p}"

    # Sampled check: repeated measurements (fresh draws on the pre-collapse
    # state — the no-remeasure rule applies to physics runs, not testing).
    keys = jax.random.split(jax.random.PRNGKey(42), N_SAMPLES)
    rs = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(keys)
    cum = jnp.cumsum(jnp.asarray(probs))
    idxs = jax.vmap(lambda r: jnp.minimum(jnp.searchsorted(cum, r, side="left"), cum.shape[0] - 1))(rs)
    counts: dict[float, int] = {}
    for idx in np.asarray(idxs):
        w = read_omega(int(idx), L, M)
        counts[w] = counts.get(w, 0) + 1
    assert set(counts) <= {0.0, 0.25, 0.5, 0.75}
    # binomial(400, 0.25): sigma ~ 8.7; allow 5 sigma.
    for w in (0.0, 0.25, 0.5, 0.75):
        c = counts.get(w, 0)
        assert abs(c - 100) < 44, f"omega={w}: count {c} outside 5 sigma"


def test_measured_m_register_consistency():
    """After the modular-exponentiation ladder, the M register's support must
    be exactly the orbit {a^x mod C} = {1, 7, 4, 13} for a=7, C=15."""
    C, a, L, M = 15, 7, 3, 4
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    from quantumcomputer.models.shor_circuit import hadamard_layer, modexp_ladder

    circ = tuple(hadamard_layer(L, M) + modexp_ladder(C, a, L, M))
    state = eng.to_numpy(eng.run(circ))
    support_m = {idx & ((1 << M) - 1) for idx in np.nonzero(np.abs(state) > 1e-12)[0]}
    assert support_m == {1, 7, 4, 13}
