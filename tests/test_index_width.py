"""Index-width audit (VERDICT r2, weak #5 / next-round item 6).

Basis indices are int32 in-program (without x64): a single device holds
exactly up to n = 31 (largest index 2^31 - 1 = int32 max); the mesh engine
reaches n = 32 by keeping (device, local) index pairs in-program and
composing them on the HOST, where Python ints are arbitrary-precision.
The reference documents its own 32-qubit bound the same way
(qc_shor.c:68-73).

Real 2^31 states need 16 GiB and cannot be allocated here; these tests
check the GEOMETRY of the index math (dtypes, bounds, split/compose
round-trips) plus the guards users actually hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.cli import main
from quantumcomputer.ops import measure
from quantumcomputer.sim.engine import Register, StateVectorEngine


def test_block_geom_int32_exact_at_2_31():
    """At dim = 2^31 the sampler's start arithmetic peaks at exactly
    int32 max; one more qubit is an explicit error, not a silent wrap."""
    dim = 1 << 31
    nblocks, block = measure.block_geom(dim)
    max_start = (nblocks - 1) * block
    max_index = max_start + block - 1
    assert max_index == 2**31 - 1 == np.iinfo(np.int32).max
    # b * block computed in int32 must not wrap for any block index
    assert np.int32(nblocks - 1) * np.int64(block) <= np.iinfo(np.int32).max
    with pytest.raises(ValueError, match="int32 index budget"):
        measure.block_geom(1 << 32)


def test_single_chip_engine_caps_at_31_without_x64(monkeypatch):
    """n = 32 on a single device requires x64."""
    # x64 is ON in the test harness, so n=32 constructs fine there...
    assert jax.config.jax_enable_x64
    StateVectorEngine(Register(L=16, M=16), dtype=jnp.complex64)
    # ...and is rejected when x64 is off (the default).
    import quantumcomputer.sim.engine as eng_mod

    monkeypatch.setattr(eng_mod, "_x64_enabled", lambda: False)
    with pytest.raises(ValueError, match="int32 basis-index"):
        StateVectorEngine(Register(L=16, M=16), dtype=jnp.complex64)
    StateVectorEngine(Register(L=16, M=15), dtype=jnp.complex64)  # n=31 ok


def test_cli_validation_matches_reality():
    # n = 32 single-device: rejected with the sharding hint.
    assert main(["-C", "15", "-L", "16", "-M", "16"]) == 2
    # n = 33: beyond even the reference's bound.
    assert main(["-C", "15", "-L", "17", "-M", "16"]) == 2


def test_mesh_measurement_splits_index():
    """The mesh programs return (device, local) int32 pairs; the host
    composition must reproduce the flat global index exactly."""
    from quantumcomputer.models.shor_circuit import shor_circuit
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    C, a, L, M = 15, 7, 3, 4
    circ = shor_circuit(C, a, L, M)
    mesh = build_mesh(num_devices=8)
    eng = ShardedStateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, mesh=mesh)
    single = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    k = jax.random.PRNGKey(5)
    # same draw -> same index on both engines (identical distributions and
    # inverse-CDF conventions at complex128)
    i_mesh = eng.run_and_measure_index(circ, k)
    i_single = single.run_and_measure_index(circ, k)
    assert i_mesh == i_single
    # collapse matches the composed index
    idx, collapsed = eng.run_and_measure(circ, k)
    amps = eng.to_numpy(collapsed)
    assert amps[idx] == 1.0 and np.count_nonzero(amps) == 1
    # _global_index composes without overflow at synthetic n = 32 geometry
    eng32 = object.__new__(ShardedStateVectorEngine)
    eng32.register = Register(L=16, M=16)
    eng32.d = 3
    assert eng32._global_index(7, (1 << 29) - 1) == 7 * (1 << 29) + (1 << 29) - 1 == (1 << 32) - 1


def test_mesh_sample_int32_programs():
    """sample() programs carry no int64 ops (the int32 (dev, loc) split),
    and host composition widens to int64."""
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64, mesh=mesh)
    state = eng.initial_state()
    shots = eng.sample(state, jax.random.PRNGKey(0), 16)
    assert shots.dtype == np.int64  # host-side compose
    np.testing.assert_array_equal(shots, 1)  # |0..01> -> index 1 always


def test_cli_allows_n32_complex128_on_cpu():
    """complex128 routes to CPU under x64 (64-bit indices): the reference's
    full 32-qubit bound stays reachable there (reviewer r3: the int32 CLI
    check must not block it)."""
    from quantumcomputer.cli import validate, build_parser

    args = build_parser().parse_args(
        ["-C", "15", "-L", "16", "-M", "16", "--dtype", "complex128"]
    )
    assert validate(args) is None
    args2 = build_parser().parse_args(["-C", "15", "-L", "16", "-M", "16"])
    assert validate(args2) is not None
