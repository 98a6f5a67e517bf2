"""Two-level sampler (ops/measure.py): block sums + in-block scan vs the
flat reference scan, on the engine's own measurement paths."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from quantumcomputer.ops import measure as pm
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim import statevec as sv
from quantumcomputer.sim.engine import Register, StateVectorEngine, _measure_planar_impl
from tests.conftest import random_state

N = 17  # dim 131072 >= MIN_BLOCKED_DIM: the two-level path


def planar_of(psi):
    return sv.from_numpy_complex(psi, jnp.float32)


def test_block_sums(rng):
    psi = random_state(N, rng)
    planar = planar_of(psi)
    sums = np.asarray(pm.block_prob_sums_planes(planar[0], planar[1]))
    nblocks, block = pm.block_geom(1 << N)
    want = (np.abs(psi) ** 2).reshape(nblocks, block).sum(axis=1)
    np.testing.assert_allclose(sums, want, atol=1e-6)
    assert abs(sums.sum() - 1.0) < 1e-5


def test_hierarchical_sample_matches_flat(rng):
    psi = random_state(N, rng)
    planar = planar_of(psi)
    probs64 = np.abs(psi) ** 2
    for r in (0.0, 0.1, 0.31, 0.5, 0.77, 0.999, 1.5):
        got = int(pm.sample_index_planes(planar[0], planar[1], jnp.float32(r)))
        want = ref.measure_index(psi, r)
        # f32 partial sums can disagree with the f64 scan only by a
        # knife-edge index; accept an index whose cumulative neighborhood
        # brackets r within f32 rounding.
        if got != want:
            cum = np.cumsum(probs64)
            lo = cum[got - 1] if got > 0 else 0.0
            hi = cum[got]
            assert lo - 1e-5 <= min(r, cum[-1]) <= hi + 1e-5, (r, got, want)


def test_knife_edge_draws_land_on_block_boundaries():
    """Draws exactly at a block's cumulative edge pick the last nonzero
    index at or before that edge (smallest index whose cumsum reaches the
    draw), the same as the flat scan."""
    dim = 1 << N
    nblocks, block = pm.block_geom(dim)
    re = np.zeros(dim, np.float32)
    # One amplitude at the END of each of four blocks: 0.25 each.
    for k in range(4):
        re[(k + 1) * block - 1] = 0.5
    rej, imj = jnp.asarray(re), jnp.zeros(dim, jnp.float32)
    for k, r in enumerate((0.25, 0.5, 0.75)):
        got = int(pm.sample_index_planes(rej, imj, jnp.float32(r)))
        flat = int(pm.flat_sample_indices_planes(rej, imj, jnp.float32(r)))
        assert got == flat == (k + 1) * block - 1, (r, got, flat)


def test_sampling_distribution(rng):
    # Concentrated state: index 777 carries 97% probability; sampling must
    # hit it for draws inside its cumulative band.
    dim = 1 << N
    psi = np.full(dim, np.sqrt(0.03 / (dim - 1)), dtype=np.complex128)
    psi[777] = np.sqrt(0.97)
    planar = planar_of(psi)
    hits = 0
    for seed in range(20):
        r = float(jax.random.uniform(jax.random.PRNGKey(seed)))
        idx = int(pm.sample_index_planes(planar[0], planar[1], jnp.float32(r)))
        hits += idx == 777
    assert hits >= 18


def test_batched_sample_indices(rng):
    """Batched two-level sampling: same distribution as the flat scan,
    no full-state cumsum.  Concentrated state must dominate the draws."""
    dim = 1 << N
    psi = np.full(dim, np.sqrt(0.05 / (dim - 1)), dtype=np.complex128)
    psi[4242] = np.sqrt(0.95)
    planar = planar_of(psi)
    rs = jax.random.uniform(jax.random.PRNGKey(7), (500,), jnp.float32)
    idx = np.asarray(pm.sample_indices(planar, rs))
    assert idx.shape == (500,)
    assert (idx == 4242).mean() > 0.9
    assert ((idx >= 0) & (idx < dim)).all()


def test_shot_chunking_matches_unchunked(rng, monkeypatch):
    """Shot batches larger than one chunk run through lax.map chunks (with
    padding for a ragged last chunk) and give the same indices."""
    psi = random_state(N, rng)
    planar = planar_of(psi)
    rs = jax.random.uniform(jax.random.PRNGKey(11), (37,), jnp.float32)
    whole = np.asarray(pm.sample_indices_planes(planar[0], planar[1], rs))
    _, block = pm.block_geom(1 << N)
    monkeypatch.setattr(pm, "_CHUNK_ELEMS", 4 * block)  # 4 shots per chunk
    chunked = np.asarray(pm.sample_indices_planes(planar[0], planar[1], rs))
    np.testing.assert_array_equal(chunked, whole)


def test_engine_sample_hierarchical(rng):
    """engine.sample at n=17/f32 routes through the batched two-level path
    and matches the flat-scan statistics."""
    psi = random_state(N, rng)
    eng = StateVectorEngine(Register(L=N, M=0), dtype=jnp.complex64)
    state = planar_of(psi)
    idx = np.asarray(eng.sample(state, jax.random.PRNGKey(3), 256))
    assert idx.shape == (256,)
    # empirical mean probability of sampled indices should be far above
    # uniform (sampling weights by |amp|^2)
    probs = np.abs(psi) ** 2
    assert probs[idx].mean() > probs.mean()


def test_engine_measure_uses_hierarchical_path(rng):
    # f32 state at n=17 routes through the block reduction inside the
    # jitted measure program; collapse must still be a valid one-hot.
    psi = random_state(N, rng)
    planar = planar_of(psi)
    idx, collapsed = jax.jit(_measure_planar_impl)(planar, jax.random.PRNGKey(3))
    c = np.asarray(collapsed)
    assert c[0].sum() == 1.0 and c[0][int(idx)] == 1.0 and c[1].sum() == 0.0


@pytest.mark.parametrize(
    "rdtype,dim,blocked",
    [
        (jnp.float32, 1 << 16, True),
        (jnp.float32, (1 << 16) - 1, False),
        (jnp.bfloat16, 1 << 16, True),
        (jnp.float64, 1 << 20, False),
    ],
)
def test_threshold_and_dtype_choose_the_path(rdtype, dim, blocked):
    """The two-level path serves f32/bf16 states of >= 2^16 amplitudes;
    smaller states and f64 (the parity mode) keep the flat scan."""
    assert pm.uses_blocks(rdtype, dim) is blocked


def test_block_geom_large_states():
    """The square-root split keeps both scans ~sqrt(dim) at every size up
    to the int32 index bound."""
    for n in (16, 17, 24, 29, 30, 31):
        nblocks, block = pm.block_geom(1 << n)
        assert nblocks * block == 1 << n
        assert block >= nblocks and block <= 2 * nblocks


def test_single_and_batch_samplers_agree_unnormalized():
    """sample_index_planes scales its draw by the total like the batched
    sampler: on an UNNORMALIZED state (bf16-style drift, total < 1) a
    near-1 draw must not fall through to the last basis index."""
    dim = 1 << 16
    re = np.zeros(dim, np.float32)
    re[5] = np.sqrt(0.5)
    re[dim // 2] = np.sqrt(0.4)  # total 0.9 < 1
    im = np.zeros(dim, np.float32)
    rej, imj = jnp.asarray(re), jnp.asarray(im)
    r = jnp.asarray(0.97, jnp.float32)  # in (total, 1): unscaled -> dim-1
    single = int(pm.sample_index_planes(rej, imj, r))
    batch = int(pm.sample_indices_planes(rej, imj, jnp.asarray([0.97], jnp.float32))[0])
    assert single == batch == dim // 2


def test_bf16_drift_sampled_in_f32():
    """bf16 planes whose |amp|^2 total drifts below 1 sample in f32 with
    the draw scaled by the drifted total, on the two-level path."""
    dim = 1 << 17
    re = np.zeros(dim, np.float32)
    re[3] = 0.7
    re[dim - 9] = 0.7  # total 0.98 after bf16 rounding of 0.7
    planes = jnp.asarray(np.stack([re, np.zeros(dim, np.float32)])).astype(ml_dtypes.bfloat16)
    assert pm.uses_blocks(planes.dtype, dim)
    sums = pm.block_prob_sums_planes(planes[0], planes[1])
    assert sums.dtype == jnp.float32
    for r, want in ((0.2, 3), (0.49, 3), (0.51, dim - 9), (0.999, dim - 9)):
        assert int(pm.sample_index_planes(planes[0], planes[1], jnp.float32(r))) == want


def test_flat_sampler_scales_by_total():
    """The flat (small-dim) engine sampler scales its draw by the total
    probability like the two-level one: a norm-deficient bf16 state must
    never route the deficit to the last basis index."""
    dim = 1 << 10
    re = np.zeros(dim, np.float32)
    re[5] = 0.996  # bf16 rounds |amp|^2 total below 1
    planes = jnp.asarray(np.stack([re, np.zeros(dim, np.float32)])).astype(ml_dtypes.bfloat16)
    eng = StateVectorEngine(Register(L=10, M=0), dtype="complex32")
    for seed in range(8):
        idx, _ = eng.measure(planes + 0, jax.random.PRNGKey(seed))
        assert int(idx) == 5
    shots = np.asarray(eng.sample(planes, jax.random.PRNGKey(1), 64))
    assert (shots == 5).all()
