"""Profiling utilities: cost accounting, roofline, norm-trace regression."""

import jax.numpy as jnp
import numpy as np

from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_reference
from quantumcomputer.sim.engine import Register, StateVectorEngine
from quantumcomputer.utils import profiling as prof


def test_bytes_accounting():
    assert prof.bytes_per_state(10) == 2 * 1024 * 4
    circ = shor_circuit(15, 7, 3, 4)
    costs = prof.circuit_cost(circ, 7)
    assert len(costs) == len(circ)
    assert all(c.bytes_moved == 2 * prof.bytes_per_state(7) for c in costs)


def test_roofline_projection():
    circ = shor_circuit(15, 7, 3, 4)
    t = prof.roofline_seconds(circ, 28, hbm_gbps=819.0)
    # 9 gates x 2 x 2GB / 819GB/s ~ 47ms
    assert 0.01 < t < 1.0


def test_time_circuit_runs():
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    t = prof.time_circuit(eng, shor_circuit(15, 7, 3, 4), iters=2)
    assert t > 0


def test_phase_profile():
    from quantumcomputer.models.shor_circuit import (
        hadamard_layer,
        inverse_qft_fused,
        modexp_ladder,
    )

    C, a, L, M = 15, 7, 3, 4
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    phases = [
        ("H layer", hadamard_layer(L, M)),
        ("oracle ladder", modexp_ladder(C, a, L, M)),
        ("inverse QFT", inverse_qft_fused(L, M)),
    ]
    out = prof.phase_profile(eng, phases, iters=1)
    assert [p.label for p in out] == ["H layer", "oracle ladder", "inverse QFT"]
    assert [p.n_gates for p in out] == [3, 3, 3]
    assert all(p.seconds >= 0.0 for p in out)


def test_norm_trace_fig2_regression():
    """Report §IV.A / FIG. 2: norm deviation stays at double round-off
    through every gate of factoring 39 (L=6, M=6)."""
    eng = StateVectorEngine(Register(L=6, M=6), dtype=jnp.complex128, fuse=False)
    tr = prof.norm_trace(eng, shor_circuit_reference(39, 7, 6, 6))
    # gate-for-gate: 3L + L(L-1)/2 applications (SURVEY.md §3.2)
    assert len(tr.deviations) == 3 * 6 + 6 * 5 // 2
    assert tr.max_deviation < 1e-13
    d = tr.to_dict()
    assert d["max_deviation"] == tr.max_deviation


def test_collective_stats_parses_real_mesh_program():
    """collective_stats reads the lowered StableHLO of a real shard_map
    program: per-operand entries (pytree ppermutes give one per plane),
    correct shapes/dtypes/byte counts, region ops (all_reduce) included."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import AXIS
    from quantumcomputer.utils.profiling import collective_bytes, collective_stats

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs 4 virtual devices")
    mesh = build_mesh(num_devices=4)
    ring = [(p, (p + 1) % 4) for p in range(4)]

    def body():
        me = lax.axis_index(AXIS)
        y = lax.ppermute(jnp.ones((8, 16), jnp.float32) * me, AXIS, ring)
        # DISTINCT plane constants: identical operands would be CSE'd into
        # one collective and undercount the pair.
        planes = (jnp.ones((4, 2), jnp.bfloat16) * me, jnp.full((4, 2), 2, jnp.bfloat16) * me)
        pb = lax.ppermute(planes, AXIS, ring)
        s = lax.psum(jnp.sum(y), AXIS)
        return s + jnp.sum((pb[0] + pb[1]).astype(jnp.float32))

    txt = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(), out_specs=P(), check_vma=False)
    ).lower().as_text()

    ops = collective_stats(txt)
    perms = [o for o in ops if o.kind == "collective_permute"]
    assert sorted(o.bytes for o in perms) == [16, 16, 512]  # 2 bf16 planes + 1 f32
    assert {o.dtype for o in perms} == {"f32", "bf16"}
    assert any(o.kind == "all_reduce" for o in ops)
    assert collective_bytes(txt, "collective_permute") == 544


def test_mesh_collective_report():
    """The abstract-lowering report: c32 ships HALF the c64 ICI bytes on
    the same m_high circuit (plane-pair bf16 collectives), with no device
    execution; single-chip engines are rejected."""
    import jax
    import jax.numpy as jnp
    import pytest

    from quantumcomputer import Register, ShardedStateVectorEngine, StateVectorEngine, build_mesh
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
    from quantumcomputer.utils.profiling import mesh_collective_report

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = build_mesh(num_devices=4)
    circ = shor_circuit_mhigh(33, 29, 6, 6)
    reg = Register(L=6, M=6)
    e64 = ShardedStateVectorEngine(reg, dtype=jnp.complex64, mesh=mesh, layout="m_high")
    e32 = ShardedStateVectorEngine(reg, dtype="complex32", mesh=mesh, layout="m_high")
    r64 = mesh_collective_report(e64, circ)
    r32 = mesh_collective_report(e32, circ)
    assert r64["total_bytes"] > 0 and "collective_permute" in r64
    assert r32["total_bytes"] * 2 == r64["total_bytes"]
    assert sum(v["bytes"] for k, v in r64.items() if k != "total_bytes") == r64["total_bytes"]
    with pytest.raises(ValueError):
        mesh_collective_report(StateVectorEngine(reg), circ)


def test_collective_stats_ignores_attribute_colons():
    """Attribute dicts contain `: tensor<...>` (dense attrs) — the parser
    must take the trailing function signature, not the attribute type."""
    from quantumcomputer.utils.profiling import collective_stats

    txt = (
        '%9 = "stablehlo.collective_permute"(%8) <{source_target_pairs = '
        "dense<[[0, 1]]> : tensor<1x2xi64>}> : (tensor<32x4xbf16>) -> tensor<32x4xbf16>"
    )
    (op,) = collective_stats(txt)
    assert op.shape == (32, 4) and op.dtype == "bf16" and op.bytes == 256
