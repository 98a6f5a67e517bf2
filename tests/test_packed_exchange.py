"""Packed-row exchange for the static m_high mesh oracle (VERDICT r2 #2).

The modular-multiply row permutation is compile-time known, so the mesh
oracle ships each partner device only the rows it needs instead of
rotating full shards D times.  These tests check the static schedule
reconstructs the permutation exactly, and assert the program-level traffic
contract: collective operands sum to less than ONE shard of rows (vs
(D-1) full shards for the rotate-blend), and only one full-shard gather
remains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.circuit import Gate
from quantumcomputer.ops.gates import modmul_inverse_permutation
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import (
    ShardedStateVectorEngine,
    _packed_exchange_schedule,
)
from quantumcomputer.sim.engine import Register, StateVectorEngine

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.mark.parametrize("C,atox,m_reg,d", [(33, 29, 6, 3), (33, 29, 6, 2), (13, 6, 4, 2), (8191 % 127, 13, 7, 3)])
def test_schedule_reconstructs_permutation(C, atox, m_reg, d):
    """Replaying local_idx + send/recv tables on host must reproduce the
    row permutation exactly (every destination row filled once)."""
    D = 1 << d
    R = (1 << m_reg) >> d
    local_idx, schedule = _packed_exchange_schedule(C, atox, m_reg, d)
    src = np.asarray(modmul_inverse_permutation(C, atox, m_reg), np.int64)

    x = np.arange(D * R).reshape(D, R)  # value = global row id
    out = np.empty_like(x)
    for k in range(D):
        out[k] = x[k][local_idx[k]]
    for delta, send_idx, recv_dst in schedule:
        for p in range(D):  # sender
            k = (p + delta) % (1 << d)  # receiver
            buf = x[p][send_idx[p]]
            keep = recv_dst[k] < R
            out[k][recv_dst[k][keep]] = buf[keep]
    np.testing.assert_array_equal(out.ravel(), src)


def test_schedule_volume_under_one_shard():
    """Total shipped rows across all offsets stays below ~1.5 shards even
    with per-offset padding (near-uniform modular spread)."""
    for C, atox, m_reg, d in [(33, 29, 6, 3), (97, 13, 7, 3), (127, 45, 7, 2)]:
        R = (1 << m_reg) >> d
        _, schedule = _packed_exchange_schedule(C, atox, m_reg, d)
        shipped = sum(send.shape[1] for _, send, _ in schedule)
        assert shipped <= 1.5 * R, (C, atox, m_reg, d, shipped, R)


def test_mesh_oracle_collectives_are_packed():
    """HLO contract (VERDICT r2 item 2 'done' criterion): for one static
    camodc_high on the mesh, the lowered program's collective-permute
    operands are packed row buffers summing to < one shard — NOT the
    (D-1) full-shard rotations of the old form — and exactly one
    full-shard row gather remains (the local-source pass)."""
    from quantumcomputer.utils.profiling import collective_stats

    L, M, d = 6, 6, 3
    C, atox = 33, 29
    mesh = build_mesh(num_devices=1 << d)
    eng = ShardedStateVectorEngine(
        Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh, layout="m_high"
    )
    circ = (Gate("camodc_high", (0,), meta=(C, atox, M)),)
    planar = eng.initial_state()
    txt = eng._compiled_run(circ).lower(planar).as_text()

    R = (1 << M) >> d
    rows_shipped = [o.shape[0] for o in collective_stats(txt) if o.kind == "collective_permute"]
    assert rows_shipped, "no collectives found in lowered program"
    assert all(r < R for r in rows_shipped), (rows_shipped, R)
    assert sum(rows_shipped) <= 1.5 * R


def test_packed_oracle_parity_1e12():
    """Mesh-vs-single parity at complex128 through the packed exchange."""
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

    C, a, L, M = 33, 29, 6, 6
    circ = shor_circuit_mhigh(C, a, L, M)
    for d in (1, 2, 3):
        mesh = build_mesh(num_devices=1 << d)
        single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
        multi = ShardedStateVectorEngine(
            Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh, layout="m_high"
        )
        s = single.to_numpy(single.run(circ))
        m = multi.to_numpy(multi.run(circ))
        np.testing.assert_allclose(s, m, atol=1e-12)


# ---- Hybrid packed SLOT routes (ROADMAP r3 item 3) ----------------------


@pytest.mark.parametrize("C,a,L,m_reg,d", [(33, 29, 4, 6, 3), (13, 6, 3, 4, 2), (97, 13, 5, 7, 3)])
def test_slot_routes_reconstruct_permutation(C, a, L, m_reg, d):
    """Replaying each slot's packed route tables on host must reproduce
    that slot's inverse permutation exactly."""
    from quantumcomputer.parallel.sharded import packed_slot_routes

    D = 1 << d
    R = (1 << m_reg) >> d
    routes = packed_slot_routes(C, a, L, m_reg, d)
    assert len(routes) == L
    for j, (local_idx, send_idx, recv_dst) in enumerate(routes):
        src = np.asarray(modmul_inverse_permutation(C, pow(a, 1 << j, C), m_reg), np.int64)
        x = np.arange(D * R).reshape(D, R)
        out = np.empty_like(x)
        for k in range(D):
            out[k] = x[k][local_idx[k]]
        for delta in range(1, D):
            for p in range(D):  # sender
                k = (p + delta) % D
                buf = x[p][send_idx[p, delta - 1]]
                keep = recv_dst[k, delta - 1] < R
                out[k][recv_dst[k, delta - 1][keep]] = buf[keep]
        np.testing.assert_array_equal(out.ravel(), src, err_msg=f"slot {j}")


def test_slot_routes_shapes_share_kpad():
    """All slots share ONE power-of-two K_pad (the route-class key), and
    the padded volume stays near the packed ideal (< 2 shards total)."""
    from quantumcomputer.parallel.sharded import packed_slot_routes

    # Realistic shard geometry (R >> D): padding is amortized there; tiny
    # shards (R ~ D) pay a larger padding factor but move trivial bytes.
    C, a, L, m_reg, d = 997, 7, 4, 10, 3
    D, R = 1 << d, (1 << m_reg) >> d
    routes = packed_slot_routes(C, a, L, m_reg, d)
    kpads = {r[1].shape[2] for r in routes}
    assert len(kpads) == 1
    (k_pad,) = kpads
    assert k_pad & (k_pad - 1) == 0
    assert (D - 1) * k_pad <= 2 * R  # near-uniform spread => ~R*(D-1)/D


def test_slot_packed_template_parity():
    """Template trial program WITH routes == rotation fallback == static
    circuit, for the measured index at fixed key (the values are moved,
    never recomputed, so all three agree exactly)."""
    from quantumcomputer.models.shor_circuit import (
        shor_circuit_mhigh,
        shor_circuit_template,
        shor_oracle_tables,
    )
    from quantumcomputer.parallel.sharded import packed_slot_routes

    C, a, L, M, d = 33, 29, 6, 6, 3
    mesh = build_mesh(num_devices=1 << d)
    key = jax.random.PRNGKey(7)
    for dtype in (jnp.complex64, "complex32"):
        eng = ShardedStateVectorEngine(
            Register(L=L, M=M), dtype=dtype, mesh=mesh, layout="m_high"
        )
        template = shor_circuit_template(L, M, "m_high")
        tables = shor_oracle_tables(C, a, L, M)
        routes = packed_slot_routes(C, a, L, M, d)
        idx_packed = eng.run_and_measure_index_with_tables(template, tables, key, routes=routes)
        idx_rot = eng.run_and_measure_index_with_tables(template, tables, key)
        idx_static = eng.run_and_measure_index(shor_circuit_mhigh(C, a, L, M), key)
        assert idx_packed == idx_rot == idx_static, dtype


def test_slot_packed_route_class_reuse():
    """Two trial integers in the same K_pad bucket must reuse ONE compiled
    template program (the compile-once property survives the packed form)."""
    from quantumcomputer.models.shor_circuit import (
        shor_circuit_template,
        shor_oracle_tables,
    )
    from quantumcomputer.parallel.sharded import packed_slot_routes

    C, L, M, d = 33, 4, 6, 2
    mesh = build_mesh(num_devices=1 << d)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh, layout="m_high")
    template = shor_circuit_template(L, M, "m_high")
    key = jax.random.PRNGKey(0)

    routes = {a: packed_slot_routes(C, a, L, M, d) for a in (29, 7)}
    k_pads = {r[0][1].shape[2] for r in routes.values()}
    assert len(k_pads) == 1, "test premise: both trial integers share a route-class"

    for a in (29, 7):
        eng.run_and_measure_index_with_tables(
            template, shor_oracle_tables(C, a, L, M), key, routes=routes[a]
        )
    dyn_keys = [k for k in eng._run_cache if "__run_measure_idx_dyn__" in k]
    assert len(dyn_keys) == 1, dyn_keys


def test_slot_packed_collectives_are_packed():
    """Lowered-program contract: with routes bound, every collective
    operand is a K_pad-row packed buffer — total shipped rows ~(D-1)*K_pad,
    a fraction of the rotation fallback's (D-1) full shards."""
    from quantumcomputer.utils.profiling import collective_stats

    from quantumcomputer.models.shor_circuit import (
        shor_circuit_template,
        shor_oracle_tables,
    )
    from quantumcomputer.parallel.sharded import packed_slot_routes

    C, a, L, M, d = 33, 29, 1, 6, 3
    D, R = 1 << d, (1 << M) >> d
    mesh = build_mesh(num_devices=D)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh, layout="m_high")
    template = (Gate("camodc_high_slot", (0,), meta=(0, M)),)
    tables = shor_oracle_tables(C, a, L, M)
    routes = packed_slot_routes(C, a, L, M, d)
    k_pad = routes[0][1].shape[2]

    def lowered_rows(rts):
        n, m_eff = eng.register.n, eng.m_eff
        from quantumcomputer.parallel.sharded import AXIS, apply_gate_sharded

        def body(tabs, rt):
            import jax.numpy as jnp2
            from jax import lax as lax2

            me = lax2.axis_index(AXIS)
            ls = (1 << n) // D
            z = (lax2.iota(jnp.int32, ls) == 1).astype(jnp.complex64)
            return apply_gate_sharded(
                z, template[0], n=n, M=m_eff, d=d, me=me,
                tables=tabs, routes=rt,
            )

        from jax.sharding import PartitionSpec as P2

        smapped = jax.shard_map(
            body, mesh=eng.mesh, in_specs=(P2(), P2()), out_specs=P2(AXIS), check_vma=False
        )
        tabs = tuple(jnp.asarray(np.asarray(t), jnp.int32) for t in tables)
        txt = jax.jit(smapped).lower(tabs, rts).as_text()
        return [o.shape[0] for o in collective_stats(txt) if o.kind == "collective_permute"]

    rts = tuple(tuple(jnp.asarray(t, jnp.int32) for t in r) for r in routes)
    packed_rows = lowered_rows(rts)
    rot_rows = lowered_rows(())
    assert packed_rows and all(r == k_pad for r in packed_rows), (packed_rows, k_pad)
    assert sum(packed_rows) == (D - 1) * k_pad
    assert sum(rot_rows) == (D - 1) * R  # the fallback ships full shards
    assert sum(packed_rows) < sum(rot_rows)


def test_slot_packed_trial_loop_e2e():
    """shors_algorithm on the m_high mesh (unforced trial loop) routes
    through the packed template and still factors."""
    from quantumcomputer.algorithms.shor import shors_algorithm

    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=6, M=6), dtype=jnp.complex64, mesh=mesh, layout="m_high")
    res = shors_algorithm(C=33, L=6, M=6, seed=5, engine=eng)
    assert res.ok and sorted(res.factors) == [3, 11]


def test_mesh_ladder_fusion_gated_on_device_count():
    """ROADMAP item 2: a fused m_high ladder pays (D-1) FULL-shard ppermute
    rounds; K packed singles pay ~K*(D-1)/D shards.  The mesh applier must
    therefore fuse only runs of K >= D — asserted here on the lowered
    collective volume for K=3, D=4: the singles form ships less than the
    rotation the ladder would have used."""
    from quantumcomputer.utils.profiling import collective_stats

    from jax import lax
    from jax.sharding import PartitionSpec as P2

    from quantumcomputer.parallel.sharded import AXIS, apply_circuit_sharded
    from quantumcomputer.sim.engine import fuse_oracle_ladders

    # R >> D so per-offset padding is amortized (the real regime).
    C, M, L, d = 997, 10, 3, 2
    D, n = 1 << d, M + L
    R = (1 << M) >> d
    gates = tuple(
        Gate("camodc_high", (j,), meta=(C, pow(7, 1 << j, C), M)) for j in range(L)
    )

    # The fusion pass itself: K=3 < D=4 stays singles; K=4 >= D fuses.
    assert all(g.name == "camodc_high" for g in fuse_oracle_ladders(gates, M, min_run=D))
    gates4 = tuple(
        Gate("camodc_high", (j,), meta=(C, pow(7, 1 << j, C), M)) for j in range(4)
    )
    fused4 = fuse_oracle_ladders(gates4, M, min_run=D)
    assert [g.name for g in fused4] == ["camodc_ladder_high"]

    # Lowered-volume contract for the applied circuit (fuse=True applies
    # min_run=D internally): total ppermute rows < the (D-1)*R full-shard
    # rotation a K=3 ladder would pay.
    mesh = build_mesh(num_devices=D)

    def body():
        me = lax.axis_index(AXIS)
        ls = (1 << n) // D
        z = (lax.iota(jnp.int32, ls) == 1).astype(jnp.complex64)
        return apply_circuit_sharded(z, gates, n=n, M=M, d=d, me=me)

    txt = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(), out_specs=P2(AXIS), check_vma=False)
    ).lower().as_text()
    rows = [o.shape[0] for o in collective_stats(txt) if o.kind == "collective_permute"]
    assert rows, "no collectives found"
    assert sum(rows) < (D - 1) * R, (rows, (D - 1) * R)
