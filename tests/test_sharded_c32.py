"""Sharded complex32 (bf16-storage) mode: bf16 planes through shard_map.

Round-3 capability (VERDICT r2, next-round item 1): the local shard is a
(2, ls) bf16 planar state; every shard exchange moves both planes in one
logical pytree ppermute (two half-width collectives — HALF the complex64
path's ICI bytes) and every blend upcasts to f32 inside the expression.

Parity oracle: the single-chip complex32 engine (itself verified against
complex64 in test_complex32.py).  bf16 mesh-vs-single differences come
only from rounding-order changes at shard boundaries, so tolerances are a
few bf16 ulps — much tighter than the c64-envelope bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumcomputer.models.circuit as cir
from quantumcomputer.models.shor_circuit import (
    shor_circuit,
    shor_circuit_mhigh,
    shor_circuit_template,
    shor_oracle_tables,
)
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer.sim.engine import Register, StateVectorEngine

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _amps(state) -> np.ndarray:
    re = np.asarray(state[0].astype(jnp.float32), np.float64)
    im = np.asarray(state[1].astype(jnp.float32), np.float64)
    return re + 1j * im


def _engines(L, M, d, layout="standard"):
    mesh = build_mesh(num_devices=1 << d)
    single = StateVectorEngine(
        Register(L=L, M=M), dtype="complex32", layout=layout
    )
    multi = ShardedStateVectorEngine(
        Register(L=L, M=M), dtype="complex32", mesh=mesh, layout=layout
    )
    return single, multi


@pytest.mark.parametrize("d", [2, 3])
def test_c32_standard_layout_full_shor_parity(d):
    """Full standard-layout Shor circuit (global iQFT stages + global
    oracle controls) at bf16 storage: mesh vs single chip."""
    C, a, L, M = 33, 29, 5, 6
    circ = shor_circuit(C, a, L, M)
    single, multi = _engines(L, M, d)
    s = _amps(single.run(circ))
    m = _amps(multi.run(circ))
    assert np.abs(s - m).max() < 2e-3
    assert abs(np.vdot(m, m).real - 1.0) < 5e-3


@pytest.mark.parametrize("d", [1, 2, 3])
def test_c32_mhigh_layout_full_shor_parity(d):
    """m_high layout: the oracle's row exchange crosses devices (the global
    bits live inside the work register)."""
    C, a, L, M = 33, 29, 6, 6
    circ = shor_circuit_mhigh(C, a, L, M)
    single, multi = _engines(L, M, d, layout="m_high")
    s = _amps(single.run(circ))
    m = _amps(multi.run(circ))
    assert np.abs(s - m).max() < 2e-3


def test_c32_sharded_gate_classes():
    """Every collective gate class on bf16 planes: dense 1q butterflies,
    diagonal selects, cphase hi/lo/both-global, global-control oracle."""
    L, M = 4, 4
    circ = (
        tuple(cir.H(q) for q in range(8))
        + (
            cir.RY(7, 0.7),
            cir.Z(6),
            cir.PHASE(5, 0.33),
            cir.CPHASE(7, 6, 0.21),  # both global
            cir.CPHASE(7, 1, 0.43),  # hi global, lo local
            cir.CPHASE(2, 0, 0.55),  # both local
            cir.Gate("camodc", (5,), meta=(13, 6)),  # global control
            cir.H(7),
        )
    )
    single, multi = _engines(L, M, 3)
    s = _amps(single.run(circ))
    m = _amps(multi.run(circ))
    assert np.abs(s - m).max() < 2e-3


def test_c32_sharded_folded_scalar_programs():
    """run_norm and run_and_measure_index (the memory-ceiling-safe forms)
    on the bf16 mesh path."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    _, multi = _engines(L, M, 2)
    assert abs(multi.run_norm(circ) - 1.0) < 5e-3
    idx = multi.run_and_measure_index(circ, jax.random.PRNGKey(3))
    assert 0 <= idx < (1 << (L + M))
    # Measured work register must be a power of a mod C (same physical
    # invariant the single-chip c32 test uses).
    f = idx & ((1 << M) - 1)
    assert f in {pow(a, k, C) for k in range(5)}


@pytest.mark.parametrize("layout", ["standard", "m_high"])
def test_c32_sharded_template_matches_static(layout):
    """The compile-once slot-oracle template on the bf16 mesh path: same
    measured distribution support as the static circuit."""
    C, a, L, M = 15, 7, 3, 4
    template = shor_circuit_template(L, M, layout=layout)
    tables = shor_oracle_tables(C, a, L, M)
    static = shor_circuit_mhigh(C, a, L, M) if layout == "m_high" else shor_circuit(C, a, L, M)
    _, multi = _engines(L, M, 2, layout=layout)
    k = jax.random.PRNGKey(11)
    i_t = multi.run_and_measure_index_with_tables(template, tables, k)
    i_s = multi.run_and_measure_index(static, k)
    assert i_t == i_s


def test_c32_sharded_run_with_norms():
    """FIG. 2 probability-conservation trace on the bf16 mesh path (f32
    accumulation of bf16 planes)."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    _, multi = _engines(L, M, 2)
    _, norms = multi.run_with_norms(circ)
    norms = np.asarray(norms)
    assert norms.size > 0
    np.testing.assert_allclose(norms, 1.0, atol=5e-3)


def test_c32_sharded_measure_and_sample():
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    _, multi = _engines(L, M, 2)
    idx, collapsed = multi.run_and_measure(circ, jax.random.PRNGKey(7))
    amps = _amps(collapsed)
    assert amps[idx] == 1.0 and np.abs(amps).sum() == 1.0
    state = multi.run(circ)
    shots = np.asarray(multi.sample(state, jax.random.PRNGKey(9), 64))
    ms = {int(s) & ((1 << M) - 1) for s in shots}
    assert ms <= {pow(a, k, C) for k in range(5)}


def test_c32_halves_collective_bytes_vs_c64():
    """The ICI contract (VERDICT r2 item 1 'done' criterion): for the same
    circuit, the bf16 mesh program issues at most 2x the collective-permute
    ops of the c64 program (one per plane) at one-QUARTER the bytes each —
    total collective volume HALVES."""
    import re as _re

    L, M, d = 4, 2, 3
    circ = (cir.H(5), cir.H(4), cir.H(3))  # three global butterflies
    mesh = build_mesh(num_devices=1 << d)
    e64 = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh)
    e32 = ShardedStateVectorEngine(Register(L=L, M=M), dtype="complex32", mesh=mesh)

    def collective_shapes(engine):
        # Assert on the LOWERED program (StableHLO): that is the dtype the
        # engine requests on the wire.  (The CPU backend then promotes bf16
        # collectives to f32 — it has no native bf16 — which is a platform
        # artifact.  _ppermute_planes carries an optimization barrier so
        # XLA's ConvertMover cannot hoist the blend's upcast across the
        # collective.)
        planar = engine.initial_state()
        txt = engine._compiled_run(circ).lower(planar).as_text()
        pat = _re.compile(r'"stablehlo\.collective_permute"\(%\d+\).*?tensor<(?:\d+x)*([a-z0-9<>]+)>\)\s*->')
        return [m.group(1) for m in pat.finditer(txt)]

    s64 = collective_shapes(e64)
    s32 = collective_shapes(e32)
    n64 = len(s64)
    n32 = len(s32)
    assert n64 == 3, s64  # one complex collective per global butterfly
    assert n32 <= 2 * n64, s32  # at most one per plane
    # volume: complex64 = 8 B/amp; two bf16 planes = 4 B/amp total
    bytes_of = {"complex<f32>": 8, "f32": 4, "bf16": 2, "f64": 8, "complex<f64>": 16}
    vol64 = sum(bytes_of[t] for t in s64)
    vol32 = sum(bytes_of[t] for t in s32)
    assert vol32 * 2 == vol64, (s64, s32)


def test_c32_sharded_backprop_adjoint():
    """O(1)-memory adjoint autodiff survives the bf16 mesh path."""
    L, M = 4, 2
    circ = (cir.H(5), cir.RY(4, 0.3), cir.H(1))
    _, multi = _engines(L, M, 2)

    run = multi._compiled_run(circ)
    s0 = multi.initial_state()

    def loss(planar):
        out = run(planar)
        return jnp.sum(out[0].astype(jnp.float32) ** 2 * jnp.arange(out.shape[-1], dtype=jnp.float32))

    g = jax.grad(loss)(s0)
    assert g.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(g.astype(jnp.float32))).all()
