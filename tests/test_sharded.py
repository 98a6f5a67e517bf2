"""Distributed engine: 8-virtual-device CPU mesh vs the single-chip engine.

Every gate class is exercised on globally-sharded qubits (dense 1q
butterflies via ppermute, diagonal selects, global-control oracle, global
iQFT stages), plus sharded measurement — all must match the single-device
results to 1e-12 (SURVEY.md §4: mesh semantics on forced host devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_reference
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register, StateVectorEngine

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

ATOL = 1e-12


def sharded_engine(L, M, d=3):
    mesh = build_mesh(num_devices=1 << d)
    return ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh)


def run_both(circuit, L, M, d=3):
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    multi = sharded_engine(L, M, d)
    a = single.to_numpy(single.run(circuit))
    b = multi.to_numpy(multi.run(circuit))
    return a, b


def test_global_hadamard_butterfly(rng):
    # n=6, d=3 -> qubits 3,4,5 are global.  H on every qubit.
    L, M = 4, 2
    circuit = tuple(cir.H(q) for q in range(6))
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_global_dense_1q_gates(rng):
    L, M = 4, 2
    circuit = (cir.H(5), cir.X(4), cir.RY(3, 0.7), cir.RX(5, 1.1), cir.Y(4))
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_global_diagonal_gates(rng):
    L, M = 4, 2
    circuit = (
        cir.H(5), cir.H(4), cir.H(3), cir.H(2),
        cir.Z(5), cir.PHASE(4, 0.33), cir.RZ(3, -0.9),
        cir.CPHASE(5, 4, 0.21),  # both global
        cir.CPHASE(5, 1, 0.43),  # hi global, lo local
        cir.CPHASE(2, 0, 0.55),  # both local
        cir.CZ(4, 0),
        cir.CPHASE(1, 3, 0.66),  # control local, target global (hi=3 global)
    )
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_global_dense_2q_one_global(rng):
    L, M = 4, 2
    m = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    circuit = (
        cir.H(5), cir.H(2), cir.H(0),
        cir.CNOT(4, 1),        # control global, target local
        cir.CNOT(1, 4),        # control local, target global
        cir.SWAP(5, 0),        # one global
        cir.U2Q(3, 2, m),      # hi global, lo local
    )
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_both_global_dense_2q(rng):
    # Both qubits globally sharded: quad-butterfly via three ppermutes.
    L, M = 4, 2
    m = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    circuit = (
        cir.H(5), cir.H(3), cir.H(1),
        cir.CNOT(5, 4),      # both global
        cir.CNOT(3, 5),      # both global, control below target
        cir.SWAP(4, 3),      # both global
        cir.U2Q(5, 3, m),    # arbitrary unitary, both global
    )
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_global_camodc_control():
    # n=7, d=3: qubits 4,5,6 global.  Controls at 4..6 are global; M=4 local.
    C, a_int, L, M = 15, 7, 3, 4
    circuit = shor_circuit(C, a_int, L, M)
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_global_iqft_stage():
    L, M = 4, 2
    circuit = tuple([cir.H(q) for q in range(2, 6)] + [cir.Gate("iqft_stage", (l,)) for l in (5, 4, 3, 2)])
    a, b = run_both(circuit, L, M)
    np.testing.assert_allclose(a, b, atol=ATOL)


@pytest.mark.parametrize("C,a,L,M", [(15, 7, 3, 4), (21, 2, 4, 5)])
def test_full_shor_circuit_sharded_parity(C, a, L, M):
    want = ref.shor_circuit(C, a, L, M)
    multi = sharded_engine(L, M)
    got = multi.to_numpy(multi.run(shor_circuit(C, a, L, M)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sharded_reference_sequence_parity():
    C, a, L, M = 15, 7, 3, 4
    want = ref.shor_circuit(C, a, L, M)
    multi = sharded_engine(L, M)
    got = multi.to_numpy(multi.run(shor_circuit_reference(C, a, L, M)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sharded_measurement_matches_single():
    C, a, L, M = 15, 7, 3, 4
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    multi = sharded_engine(L, M)
    circ = shor_circuit(C, a, L, M)
    s_state = single.run(circ)
    m_state = multi.run(circ)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        i1, c1 = single.measure(single.run(circ), key)
        i2, c2 = multi.measure(multi.run(circ), key)
        assert i1 == i2, f"seed {seed}: {i1} != {i2}"
        np.testing.assert_allclose(single.to_numpy(c1), multi.to_numpy(c2), atol=ATOL)


def test_sharded_norm_and_probs():
    multi = sharded_engine(3, 4)
    state = multi.run(shor_circuit(15, 7, 3, 4))
    assert abs(multi.norm(state) - 1.0) < 1e-13
    probs = np.asarray(multi.probabilities(state))
    assert abs(probs.sum() - 1.0) < 1e-13


def test_mesh_guardrails():
    mesh = build_mesh(num_devices=8)
    with pytest.raises(ValueError):
        # M register crossing the shard boundary must be rejected.
        ShardedStateVectorEngine(Register(L=1, M=3), dtype=jnp.complex128, mesh=mesh)
    with pytest.raises(ValueError):
        # Explicit non-power-of-two device count must error, not truncate.
        build_mesh(num_devices=6)
    with pytest.raises(ValueError):
        build_mesh(num_devices=999)  # more than available


def test_shors_algorithm_with_mesh():
    mesh = build_mesh(num_devices=8)
    from quantumcomputer.algorithms.shor import shors_algorithm

    res = shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128, mesh=mesh)
    assert res.ok and res.factors == (5, 3)


def test_sharded_local_fusion_parity(rng):
    # n=16, d=2 -> n_local=14: local gates take the large-state forms
    # inside shard_map; globals via collectives.  Compare against the
    # single-device engine in complex64.
    L, M = 10, 6
    C, a_int = 33, 7
    circuit = shor_circuit(C, a_int, L, M)
    mesh = build_mesh(num_devices=4)
    multi = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, mesh=mesh)
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    a = single.to_numpy(single.run(circuit))
    b = multi.to_numpy(multi.run(circuit))
    np.testing.assert_allclose(a, b, atol=3e-5)


@pytest.mark.parametrize("C,a,L,M,d", [(15, 7, 3, 4, 3), (15, 7, 3, 4, 2), (21, 2, 4, 5, 3), (33, 7, 5, 6, 3)])
def test_sharded_mhigh_full_circuit_parity(C, a, L, M, d):
    """m_high ON THE MESH (ROADMAP 4): the oracle row exchange rides
    ppermute rounds; amplitudes must match the single-chip m_high engine
    and (after the layout unmap) the logical-order reference, to 1e-12."""
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

    circ = shor_circuit_mhigh(C, a, L, M)
    mesh = build_mesh(num_devices=1 << d)
    multi = ShardedStateVectorEngine(
        Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh, layout="m_high"
    )
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, layout="m_high")
    got = multi.to_numpy(multi.run(circ))
    want = single.to_numpy(single.run(circ))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # Unmap physical m_high order -> logical order and check vs the oracle.
    n = L + M
    phys = np.arange(1 << n)
    logical = ((phys >> L) | ((phys & ((1 << L) - 1)) << M))
    got_logical = np.zeros_like(got)
    got_logical[logical] = got
    np.testing.assert_allclose(got_logical, ref.shor_circuit(C, a, L, M), atol=ATOL)


def test_sharded_mhigh_measure_and_shors():
    """End-to-end mesh + m_high: measured omegas land on harmonics and the
    driver factors 15."""
    from quantumcomputer.algorithms.shor import read_omega, shors_algorithm
    from quantumcomputer.models.shor_circuit import shor_circuit_mhigh

    mesh = build_mesh(num_devices=8)
    eng = ShardedStateVectorEngine(
        Register(L=3, M=4), dtype=jnp.complex128, mesh=mesh, layout="m_high"
    )
    circ = shor_circuit_mhigh(15, 7, 3, 4)
    key = jax.random.PRNGKey(4)
    for _ in range(10):
        key, sub = jax.random.split(key)
        idx, _ = eng.run_and_measure(circ, sub)
        assert read_omega(eng.logical_index(idx), 3, 4) in (0.0, 0.25, 0.5, 0.75)
    res = shors_algorithm(
        C=15, L=3, M=4, forced_trial_int=7, seed=0, dtype=jnp.complex128,
        mesh=mesh, layout="m_high",
    )
    assert res.ok and res.factors == (5, 3)


def test_sharded_mhigh_guardrails():
    mesh = build_mesh(num_devices=8)
    with pytest.raises(ValueError):
        # d=3 > M=2: device bits would spill out of the work register.
        ShardedStateVectorEngine(Register(L=5, M=2), dtype=jnp.complex128, mesh=mesh, layout="m_high")


def test_sharded_sample():
    """Non-collapsing batched sampling across the mesh: indices weight by
    |amp|^2 and land on the period-4 harmonics' support for Shor-15."""
    from quantumcomputer.algorithms.shor import read_omega

    multi = sharded_engine(3, 4)
    state = multi.run(shor_circuit(15, 7, 3, 4))
    idx = np.asarray(multi.sample(state, jax.random.PRNGKey(9), 200))
    assert idx.shape == (200,)
    for i in idx:
        assert read_omega(int(i), 3, 4) in (0.0, 0.25, 0.5, 0.75)
    # state NOT collapsed: norm still 1 and support unchanged
    assert abs(multi.norm(state) - 1.0) < 1e-12


def test_ici_device_ordering():
    """Multi-host/DCN policy: devices sort by comm domain so low mesh bits
    stay intra-slice (ICI) and only high bits cross DCN (SURVEY.md §5)."""
    from dataclasses import dataclass

    from quantumcomputer.parallel import mesh as pm

    @dataclass
    class Dev:
        id: int
        slice_index: int

    # interleaved arrival order across two slices
    devs = [Dev(0, 1), Dev(1, 0), Dev(2, 1), Dev(3, 0), Dev(4, 0), Dev(5, 1), Dev(6, 0), Dev(7, 1)]
    ordered = pm.order_devices_for_ici(devs)
    assert [d.slice_index for d in ordered] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert [d.id for d in ordered[:4]] == [1, 3, 4, 6]
    # single-domain devices keep their natural id order
    flat = [Dev(i, 0) for i in (3, 1, 2, 0)]
    assert [d.id for d in pm.order_devices_for_ici(flat)] == [0, 1, 2, 3]


def test_ici_degree():
    from dataclasses import dataclass

    from quantumcomputer.parallel import mesh as pm

    mesh = build_mesh(num_devices=8)  # CPU: one comm domain
    assert pm.ici_degree(mesh) == 3  # all exchanges "ICI"


def test_sharded_norm_trace():
    # FIG. 2 regression across the mesh: per-gate psum'd norms stay at 1.
    multi = sharded_engine(3, 4)
    _, norms = multi.run_with_norms(shor_circuit_reference(15, 7, 3, 4))
    devs = np.abs(np.asarray(norms) - 1.0)
    assert norms.shape[0] == 3 * 3 + 3 * 2 // 2
    assert devs.max() < 1e-13


def test_sharded_folded_scalar_programs():
    """run_norm / run_and_measure_index: the memory-ceiling-safe forms on
    the mesh (ONE shard_map program, scalar output).  The norm matches the
    single-chip engine exactly, and the index-only program draws the same
    sample as run_and_measure under the same key."""
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    multi = sharded_engine(L, M)
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    assert abs(multi.run_norm(circ) - single.run_norm(circ)) < ATOL
    key = jax.random.PRNGKey(7)
    idx_only = multi.run_and_measure_index(circ, key)
    idx_full, _ = multi.run_and_measure(circ, key)
    assert idx_only == idx_full


def test_sharded_template_oracle_matches_static():
    """Compile-once trial loop ON THE MESH: slot-oracle templates with
    replicated table operands draw the same sample as the constant-baked
    circuit for several trial integers, through ONE cached program."""
    from quantumcomputer.models.shor_circuit import (
        shor_circuit_mhigh,
        shor_circuit_template,
        shor_oracle_tables,
    )

    C, L, M = 33, 4, 6
    for layout, build in (("standard", shor_circuit), ("m_high", shor_circuit_mhigh)):
        mesh = build_mesh(num_devices=4)
        eng = ShardedStateVectorEngine(
            Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh, layout=layout
        )
        template = shor_circuit_template(L, M, layout)
        for a in (2, 5, 7):
            key = jax.random.PRNGKey(a)
            tables = shor_oracle_tables(C, a, L, M)
            idx_dyn = eng.run_and_measure_index_with_tables(template, tables, key)
            idx_static = eng.run_and_measure_index(build(C, a, L, M), key)
            assert idx_dyn == idx_static, f"{layout} a={a}"
        dyn_keys = [
            k for k in eng._run_cache
            if isinstance(k, tuple) and "__run_measure_idx_dyn__" in k and k[2] > 0
        ]
        assert len(dyn_keys) == 1


def test_mesh_subset_is_domain_aligned():
    """Selecting a power-of-two subset happens AFTER the ICI ordering and
    prefers domain-aligned blocks: 8 of 12 devices in 6+6 domains must be
    4+4 (pure 4-blocks), not the 6+2 prefix."""
    from dataclasses import dataclass

    from quantumcomputer.parallel import mesh as pm

    @dataclass(frozen=True)
    class Dev:
        id: int
        slice_index: int

    devs = [Dev(i, i // 6) for i in range(12)]
    picked = pm._pick_subset(pm.order_devices_for_ici(devs), 8)
    doms = sorted(d.slice_index for d in picked)
    assert doms == [0, 0, 0, 0, 1, 1, 1, 1]
    # whole target inside one domain when it fits
    picked4 = pm._pick_subset(pm.order_devices_for_ici(devs), 4)
    assert len({d.slice_index for d in picked4}) == 1


def test_ici_degree_unequal_domains():
    """ici_degree computes block purity directly — unequal domain sizes
    must not under-report: [A,A,B,B,B,B,B,B] has degree 1."""
    from dataclasses import dataclass

    import numpy as np

    from jax.sharding import Mesh as JMesh

    from quantumcomputer.parallel import mesh as pm

    class Dev:
        def __init__(self, id, slice_index):
            self.id = id
            self.slice_index = slice_index

    devs = [Dev(i, 0 if i < 2 else 1) for i in range(8)]

    class FakeMesh:
        def __init__(self, devs):
            self.devices = np.array(devs, dtype=object)
            self.shape = {"q": len(devs)}

    assert pm.ici_degree(FakeMesh(devs)) == 1
    # fully mixed blocks -> 0
    mixed = [Dev(i, i % 2) for i in range(8)]
    assert pm.ici_degree(FakeMesh(mixed)) == 0


def test_build_mesh_conflicting_args_rejected():
    import pytest

    from quantumcomputer.parallel import mesh as pm

    devs = jax.devices()[:4]
    with pytest.raises(ValueError, match="conflicts"):
        pm.build_mesh(num_devices=2, devices=devs)
    m = pm.build_mesh(num_devices=4, devices=devs)  # agreeing args are fine
    assert m.shape["q"] == 4
