"""Two-level inverse-CDF sampling from planar re/im planes, in plain jnp.

Replaces the reference's serial O(2^N) cumulative-probability scan
(measure_state, qc_shor.c:272-306) with a block reduction:

  1. the planes are viewed as (nblocks, block) and |re|^2 + |im|^2 is
     summed per block in the accumulation dtype — one read of the state,
     which XLA fuses into a single row reduction, with no probability
     vector written to device memory;
  2. a cumulative scan over the block sums picks the block, and a local
     scan inside the picked block picks the element.

Semantics match the reference's convention: smallest index whose
cumulative probability reaches the draw, falling through to the last
index.  Every draw is scaled by the total probability, so a norm-deficient
state (bf16 drift) never routes its deficit to the last basis index.  With
finite-precision partial sums the two-level and flat scans can differ at
knife-edge draws; both are valid inverse-CDF samplers of the same
distribution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# States below this size use the flat cumsum: it matches the reference's
# scan order exactly and the block machinery buys nothing there.
MIN_BLOCKED_DIM = 1 << 16

# Shot batches are chunked so the vmapped per-shot block scans hold at
# most this many elements at once.
_CHUNK_ELEMS = 1 << 23


def acc_dtype(rdtype):
    """Probabilities from bf16 planes sum in f32 (a bf16 accumulator loses
    the sum entirely); f32/f64 accumulate as-is."""
    return jnp.float32 if jnp.dtype(rdtype) == jnp.bfloat16 else jnp.dtype(rdtype)


def uses_blocks(rdtype, dim: int) -> bool:
    """The two-level sampler serves f32 and bf16 planes of >= 2^16
    amplitudes; f64 keeps the flat scan (the parity mode)."""
    return jnp.dtype(rdtype) in (jnp.float32, jnp.bfloat16) and dim >= MIN_BLOCKED_DIM


def block_geom(dim: int) -> tuple:
    """(nblocks, block) for a state of `dim` amplitudes: the square-root
    split, so the block-sum scan and each per-shot scan are both ~sqrt(dim).

    Index-width bound: the samplers compute start = block_index * block
    and start + local in int32, which fits exactly up to dim = 2^31
    (largest index 2^31 - 1); beyond that it is an explicit error
    (tests/test_index_width.py)."""
    if dim > (1 << 31):
        raise ValueError(
            f"dim = 2^{dim.bit_length() - 1} exceeds the int32 index budget "
            "(2^31) of the two-level sampler; shard the state instead"
        )
    n = dim.bit_length() - 1
    block = 1 << ((n + 1) // 2)
    return dim // block, block


def block_prob_sums_planes(re: jax.Array, im: jax.Array) -> jax.Array:
    """Per-block sums of |amp|^2, shape (nblocks,), in acc_dtype."""
    nblocks, block = block_geom(re.shape[-1])
    acc = acc_dtype(re.dtype)
    r = re.reshape(nblocks, block).astype(acc)
    i = im.reshape(nblocks, block).astype(acc)
    return jnp.sum(r * r + i * i, axis=1)


def _pick_block(sums: jax.Array, rs: jax.Array):
    """Scaled draws -> (block index, draw remaining inside that block)."""
    cum = jnp.cumsum(sums)
    scaled = rs.astype(cum.dtype) * cum[-1]
    b = jnp.minimum(jnp.searchsorted(cum, scaled, side="left"), sums.shape[0] - 1)
    return b, scaled - (cum[b] - sums[b])


def _pick_in_block(re, im, block: int, b, rem):
    start = (b * block).astype(jnp.int32)
    acc = acc_dtype(re.dtype)
    lre = jax.lax.dynamic_slice(re, (start,), (block,)).astype(acc)
    lim = jax.lax.dynamic_slice(im, (start,), (block,)).astype(acc)
    cs = jnp.cumsum(lre * lre + lim * lim)
    li = jnp.minimum(jnp.searchsorted(cs, rem.astype(acc), side="left"), block - 1)
    return start + li.astype(jnp.int32)


def sample_index_planes(re: jax.Array, im: jax.Array, r: jax.Array) -> jax.Array:
    """One draw `r` in [0, 1) -> basis index (traced)."""
    _, block = block_geom(re.shape[-1])
    b, rem = _pick_block(block_prob_sums_planes(re, im), r)
    return _pick_in_block(re, im, block, b, rem)


def sample_indices_planes(re: jax.Array, im: jax.Array, rs: jax.Array) -> jax.Array:
    """Batched draws `rs` (shots,) -> basis indices, from one block-sum
    pass plus per-shot work bounded by one block.  The shot batch is
    chunked so the vmapped block scans stay within _CHUNK_ELEMS elements
    whatever the shot count."""
    _, block = block_geom(re.shape[-1])
    b, rem = _pick_block(block_prob_sums_planes(re, im), rs)

    def local(bi, ri):
        return _pick_in_block(re, im, block, bi, ri)

    shots = rs.shape[0]
    chunk = max(1, min(shots, _CHUNK_ELEMS // block))
    if chunk >= shots:
        return jax.vmap(local)(b, rem)
    k = -(-shots // chunk)
    pad = k * chunk - shots
    bp = jnp.pad(b, (0, pad)).reshape(k, chunk)
    rp = jnp.pad(rem, (0, pad)).reshape(k, chunk)
    out = jax.lax.map(lambda args: jax.vmap(local)(*args), (bp, rp))
    return out.reshape(-1)[:shots]


def flat_sample_indices_planes(re: jax.Array, im: jax.Array, rs: jax.Array) -> jax.Array:
    """The flat scan (small or f64 states): one cumsum over the whole
    state, draws scaled by the total like the two-level path."""
    acc = acc_dtype(re.dtype)
    cum = jnp.cumsum(re.astype(acc) ** 2 + im.astype(acc) ** 2)
    idx = jnp.searchsorted(cum, rs.astype(acc) * cum[-1], side="left")
    return jnp.minimum(idx, re.shape[-1] - 1)


def sample_indices(planar: jax.Array, rs: jax.Array) -> jax.Array:
    """Batched draws from a planar state, choosing the two-level or flat
    scan by dtype and size (uses_blocks)."""
    re, im = planar[0], planar[1]
    if uses_blocks(re.dtype, re.shape[-1]):
        return sample_indices_planes(re, im, rs)
    return flat_sample_indices_planes(re, im, rs)


def sample_index(re: jax.Array, im: jax.Array, r: jax.Array) -> jax.Array:
    """One draw from separate planes, choosing the path like sample_indices."""
    if uses_blocks(re.dtype, re.shape[-1]):
        return sample_index_planes(re, im, r)
    return flat_sample_indices_planes(re, im, r)
