"""The uniform engine contract, pinned across ALL four engines.

Every engine (single-chip complex, sharded complex, dd64, sharded dd64)
advertises the same surface and conventions; generic algorithms
(grover/qpe/qv/bv/simon) rely on them blindly.  A divergence here is a
silent wrong-answer factory — the dd zero_state null-vector bug was
exactly this class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.circuit import H, X
from quantumcomputer.sim.engine import Register, StateVectorEngine

L, M = 3, 3
N = L + M


def _engines():
    out = [("xla-c64", StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64))]
    out.append(("xla-c128", StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)))
    out.append(
        ("c32", StateVectorEngine(Register(L=L, M=M), dtype="complex32"))
    )
    from quantumcomputer.sim.dd_engine import DDStateVectorEngine

    out.append(("dd64", DDStateVectorEngine(Register(L=L, M=M))))
    if len(jax.devices()) >= 4:
        from quantumcomputer.parallel.mesh import build_mesh
        from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
        from quantumcomputer.parallel.sharded_dd import ShardedDDStateVectorEngine

        mesh = build_mesh(num_devices=4)
        out.append(
            ("sharded-c64", ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh))
        )
        out.append(("sharded-dd", ShardedDDStateVectorEngine(Register(L=L, M=M), mesh=mesh)))
    return out


SURFACE = (
    "initial_state", "zero_state", "run", "measure", "sample",
    "probabilities", "norm", "to_numpy", "run_norm",
    "run_and_measure_index", "logical_index",
)


@pytest.mark.parametrize("name,eng", _engines(), ids=lambda v: v if isinstance(v, str) else "")
def test_engine_surface_and_conventions(name, eng):
    for attr in SURFACE:
        assert hasattr(eng, attr), f"{name} lacks {attr}"

    # zero_state: |0...0> — amplitude exactly 1 at index 0.
    z = np.asarray(eng.to_numpy(eng.zero_state()))
    assert z.shape == (1 << N,)
    assert z[0] == 1.0 and np.abs(z[1:]).max() == 0.0, f"{name} zero_state"

    # initial_state: the Shor reset |0..01> — work register = 1 at the
    # engine's (layout-dependent) physical reset index; logically index 1.
    ini = np.asarray(eng.to_numpy(eng.initial_state()))
    (nz,) = np.nonzero(np.abs(ini) > 1e-6)
    assert len(nz) == 1 and eng.logical_index(int(nz[0])) == 1, f"{name} initial_state"
    assert abs(abs(ini[nz[0]]) - 1.0) < 1e-3

    # run: unitary evolution preserves the norm; X(0) moves the reset.
    state = eng.run((H(N - 1), X(0)), eng.initial_state())
    assert abs(eng.norm(state) - 1.0) < 5e-3, f"{name} norm after run"

    # probabilities: sums to ~1, correct support (work reg 1 -> 0 under X).
    probs = np.asarray(eng.probabilities(state), np.float64)
    assert abs(probs.sum() - 1.0) < 5e-3
    # measure: valid index from the support, collapsed state normalized.
    idx, collapsed = eng.measure(state, jax.random.PRNGKey(0))
    assert 0 <= idx < (1 << N)
    assert probs[idx if name not in () else idx] > 1e-4  # measured a support index
    assert abs(eng.norm(collapsed) - 1.0) < 5e-3, f"{name} collapse norm"

    # sample: right count, all indices inside the support.
    state2 = eng.run((H(N - 1), X(0)), eng.initial_state())
    shots = np.asarray(eng.sample(state2, jax.random.PRNGKey(1), 32))
    assert shots.shape == (32,)
    assert all(probs[int(s)] > 1e-4 for s in shots), f"{name} sample support"

    # run_norm: reset-folded scalar program form, == 1 for a unitary circuit.
    assert abs(eng.run_norm((H(N - 1), X(0))) - 1.0) < 5e-3, f"{name} run_norm"

    # run_and_measure_index: scalar-output reset->circuit->measure form.
    mi = eng.run_and_measure_index((H(N - 1), X(0)), jax.random.PRNGKey(2))
    assert 0 <= int(mi) < (1 << N) and probs[int(mi)] > 1e-4, f"{name} measure_index"
