"""Sharded semiclassical period finding (parallel/sharded_semiclassical.py).

The distribution-level correctness of semiclassical mode itself is proven
in test_semiclassical.py (branch-by-branch equality with the full-register
circuit).  Here the contract is the MESH form: bit-for-bit parity with the
single-chip engine under the same key, the exactness of the host-side
Euclidean lattice counts that size the exchange buffers, and the oracle
exchange surviving its adversarial regimes (smooth multipliers, identity
regions, multiplier-1 steps)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantumcomputer.algorithms.semiclassical import run_semiclassical
from quantumcomputer.parallel.mesh import build_mesh
from quantumcomputer.parallel.sharded_semiclassical import (
    exchange_capacity,
    max_bin_load,
    run_semiclassical_sharded,
)


def _brute_max_bin_load(b, C, M, d):
    """numpy ground truth for max_bin_load (materializes the 2^M map)."""
    D, ls = 1 << d, 1 << (M - d)
    s = np.arange(1 << M)
    w = np.where(s < C, (np.int64(b) * s) % C, s)
    best = 0
    for e in range(D):
        blk = slice(e * ls, (e + 1) * ls)
        mask = s[blk] < C
        counts = np.bincount(w[blk][mask] >> (M - d), minlength=D)
        best = max(best, int(counts.max()))
    return best


def test_lattice_counts_exact():
    """The O(log C) floor-sum bin loads must equal brute force everywhere:
    smooth multipliers (near-linear maps), rough ones, b=1 (identity),
    b=C-1 (reversal), and moduli with large identity regions."""
    cases = [
        (2, 21, 5, 2), (7, 21, 5, 2), (20, 21, 5, 2),      # b = C-1
        (1, 15, 4, 1), (3, 8191, 13, 3), (8190, 8191, 13, 3),
        (16, 1019 * 1021, 20, 3), (2, 33, 6, 3),           # big identity region
        (65536, 1019 * 1021, 20, 2),
    ]
    for b, C, M, d in cases:
        assert max_bin_load(b, C, M, d) == _brute_max_bin_load(b, C, M, d), (b, C, M, d)


def test_exchange_capacity_covers_smooth_multipliers():
    """a=2's step multipliers are smooth (2, 4, 16, ...): the capacity must
    cover their concentrated bins — far above the uniform ~ls/D estimate."""
    C, M, d = 1019 * 1021, 20, 3
    ls, D = 1 << (M - d), 1 << d
    pows = [pow(2, 1 << j, C) for j in range(8)]
    cap = exchange_capacity(pows, C, M, d)
    assert cap >= max_bin_load(2, C, M, d)
    assert max_bin_load(2, C, M, d) >= ls // 2  # vs the uniform ~ls/D estimate
    # power-of-two bucketing (compile-cache friendliness)
    assert cap & (cap - 1) == 0


@pytest.mark.parametrize(
    "C,a,L,M,d",
    [
        (15, 2, 6, 4, 2),      # ord(a)=4: multiplier-1 steps (cond skip)
        (15, 7, 5, 4, 1),      # minimal mesh
        (21, 2, 7, 5, 3),      # smooth multipliers on 8 devices
        (33, 29, 6, 6, 3),     # C << 2^M: large identity region
        (8191, 3, 10, 13, 3),  # 13-bit prime modulus
    ],
)
def test_sharded_matches_single_chip(C, a, L, M, d):
    """Same key -> same bits and branch probabilities as the single-chip
    engine (the two paths share only the draw stream and the math)."""
    mesh = build_mesh(1 << d)
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        rs = run_semiclassical_sharded(C, a, L, M, key, mesh)
        r1 = run_semiclassical(C, a, L, M, key)
        assert rs.bits == r1.bits
        np.testing.assert_allclose(rs.branch_probs, r1.branch_probs, atol=5e-6)
        assert rs.x_tilde == r1.x_tilde and rs.omega == r1.omega


def test_sharded_forced_branch_parity():
    """Forced walks reproduce the single-chip exact branch weights — the
    distribution-equality hook works across the mesh."""
    C, a, L, M = 21, 2, 6, 5
    mesh = build_mesh(4)
    for forced in ([0] * 6, [1] * 6, [1, 0, 1, 1, 0, 1]):
        rs = run_semiclassical_sharded(
            C, a, L, M, jax.random.PRNGKey(0), mesh, forced_bits=forced
        )
        r1 = run_semiclassical(
            C, a, L, M, jax.random.PRNGKey(0), forced_bits=forced
        )
        assert rs.bits == r1.bits == forced
        np.testing.assert_allclose(rs.branch_probs, r1.branch_probs, atol=5e-6)


def test_sharded_large_modulus_end_to_end():
    """The 20-bit semiprime factors through the mesh engine: the sharded
    attempt feeds the same CF pipeline (the capability the mesh exists
    for — moduli past the single-chip HBM ceiling)."""
    from quantumcomputer.algorithms import number_theory as nt

    C, a, L, M = 1019 * 1021, 2, 40, 20
    mesh = build_mesh(8)
    rec = run_semiclassical_sharded(C, a, L, M, jax.random.PRNGKey(0), mesh)
    period = nt.find_period_from_omega(rec.omega, a, C)
    assert period is not None and pow(a, period, C) == 1
    half = pow(a, period // 2, C)
    f = np.gcd(half - 1, C)
    assert 1 < f < C and C % f == 0


def test_lowered_collective_profile():
    """The program's collective inventory IS the design: exactly ONE
    all_to_all (the oracle exchange, shared by every fori_loop iteration)
    and three all_reduces (p0, p1, overflow) — no all_gather (nothing
    materializes the full state) and no collective_permute (no rotation
    rounds).  Asserted on the lowered StableHLO, where platform lowering
    cannot have rewritten the collectives yet."""
    import re

    from quantumcomputer.parallel.sharded_semiclassical import _attempt_fn

    mesh = build_mesh(8)
    fn = _attempt_fn(6, 10, 3, jnp.float32, 64, mesh)
    txt = fn.lower(
        jnp.int32(1019), jnp.zeros((6,), jnp.int32), jnp.zeros((6,), jnp.int32),
        jnp.zeros((6,), jnp.float32), jnp.zeros((6,), jnp.int32),
    ).as_text()
    assert len(re.findall(r"all_to_all", txt)) == 1
    assert len(re.findall(r"all_gather", txt)) == 0
    assert len(re.findall(r"collective_permute", txt)) == 0
    assert len(re.findall(r"all_reduce", txt)) == 3


def test_modmul_onchip_int32_boundary():
    """The shift-add modular multiply must be exact at the int32 limit:
    C just under 2^30 (intermediates reach ~2C ~ 2^31) — the bound that
    sets the sharded-semiclassical modulus ceiling."""
    from quantumcomputer.ops.gates import modmul_onchip

    for C in [(1 << 30) - 35, (1 << 30) - 1, (1 << 29) + 1]:
        rng = np.random.default_rng(C & 0xFFFF)
        js = np.concatenate([
            np.array([0, 1, 2, C - 1, C - 2, C // 2]),
            rng.integers(0, C, 32),
        ]).astype(np.int64)
        for a in [2, 3, C - 1, C // 2, 982451653 % C]:
            exp = (a * js) % C
            got = jax.jit(
                lambda aa, jj, M=30: modmul_onchip(aa, jj, jnp.int32(C), M)
            )(jnp.int32(a), jnp.asarray(js, jnp.int32))
            np.testing.assert_array_equal(np.asarray(got, np.int64), exp, err_msg=f"C={C} a={a}")


def test_sharded_bounds():
    mesh = build_mesh(4)
    key = jax.random.PRNGKey(0)
    with pytest.raises(ValueError, match="not unitary"):
        run_semiclassical_sharded(33, 2, 4, 5, key, mesh)
    with pytest.raises(ValueError, match="shift-add"):
        run_semiclassical_sharded((1 << 30) + 1, 2, 4, 31, key, mesh)
    with pytest.raises(ValueError, match="mantissa"):
        run_semiclassical_sharded(15, 7, 53, 4, key, mesh)
    with pytest.raises(ValueError, match="coprime|permutation"):
        run_semiclassical_sharded(15, 5, 4, 4, key, mesh)
    with pytest.raises(ValueError, match="too small"):
        run_semiclassical_sharded(5, 2, 4, 3, key, build_mesh(8))


def test_sharded_complex32_matches_single_chip():
    """complex32 on the mesh: the exchange moves bf16 amplitudes (half the
    ICI bytes of c64) while angles/probability psums run in f32 — same
    bits as the single-chip complex32 engine under the same key."""
    mesh = build_mesh(4)
    C, a, L, M = 21, 2, 6, 5
    for seed in (0, 5):
        key = jax.random.PRNGKey(seed)
        single = run_semiclassical(C, a, L, M, key, dtype="complex32", fused=False)
        shard = run_semiclassical_sharded(C, a, L, M, key, mesh, dtype="complex32")
        assert shard.bits == single.bits
        np.testing.assert_allclose(
            shard.branch_probs, single.branch_probs, atol=1e-4
        )


def test_sharded_exchange_dtype_is_bf16_at_complex32():
    """The one all_to_all must carry bf16 at complex32 — asserted on the
    LOWERED StableHLO (platform lowering may widen collectives later)."""
    import re

    from quantumcomputer.parallel.sharded_semiclassical import _attempt_fn

    mesh = build_mesh(8)
    fn = _attempt_fn(6, 10, 3, jnp.bfloat16, 64, mesh)
    txt = fn.lower(
        jnp.int32(1019), jnp.zeros((6,), jnp.int32), jnp.zeros((6,), jnp.int32),
        jnp.zeros((6,), jnp.float32), jnp.zeros((6,), jnp.int32),
    ).as_text()
    m = re.findall(r'stablehlo\.custom_call[^\n]*all_to_all[^\n]*|%\d+ = [^\n]*all_to_all[^\n]*', txt)
    assert m, "no all_to_all found in lowered module"
    assert any("bf16" in line for line in m), m


def test_sharded_memory_gate(monkeypatch):
    """An oversized per-chip shard must raise a descriptive ValueError
    before dispatch, not an opaque device OOM mid-attempt."""
    import pytest

    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded_semiclassical import (
        run_semiclassical_sharded,
        sharded_attempt_fits,
    )
    from quantumcomputer.utils import memory as qmem

    monkeypatch.setenv("QC_HBM_BYTES", str(1 << 20))  # 1 MiB chip
    assert not sharded_attempt_fits(20, jnp.float32, 2)
    assert sharded_attempt_fits(12, jnp.float32, 2)
    mesh = build_mesh(num_devices=4)
    with pytest.raises(ValueError, match="exceeds the .* device budget"):
        run_semiclassical_sharded(64901, 2, 4, 17, jax.random.PRNGKey(0), mesh)


def test_mesh_cache_keyed_by_content():
    """The compiled-program cache keys by mesh CONTENT (device ids + axis
    names), never id(mesh): a process building fresh meshes cannot
    accumulate one pinned program per Mesh object."""
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded_semiclassical import (
        run_semiclassical_sharded,
    )

    mesh = build_mesh(num_devices=4)
    cache: dict = {}
    r1 = run_semiclassical_sharded(15, 2, 4, 4, jax.random.PRNGKey(3), mesh, _cache=cache)
    (key,) = cache.keys()
    # The mesh component of the key is (device ids, axis names) — plain
    # data, not an object identity.
    dev_ids, axes = key[-1]
    assert dev_ids == tuple(d.id for d in mesh.devices.flat) and axes == mesh.axis_names
    r2 = run_semiclassical_sharded(15, 2, 4, 4, jax.random.PRNGKey(3), mesh, _cache=cache)
    assert len(cache) == 1 and r1.bits == r2.bits
