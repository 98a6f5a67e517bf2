"""Planar state-vector representation: the device-boundary format.

At program boundaries the engine represents a state as a single real
array of shape (2, 2^n) — plane 0 = Re(psi), plane 1 = Im(psi) — and
complex arithmetic exists only *inside* traced computations.  One format
serves every precision:

float32 planes <-> complex64 semantics; float64 <-> complex128; bfloat16
planes <-> the storage-only "complex32" mode (no complex dtype exists at
that width — gates upcast to f32, compute at full f32 precision, and
round back to bf16 only on the store, halving every pass's memory
traffic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: dtype token for the bf16-storage throughput mode.  Not a real JAX dtype
#: (JAX has no 32-bit complex); accepted by the engine's `dtype=` argument.
COMPLEX32 = "complex32"


def real_dtype_of(cdtype) -> jnp.dtype:
    if isinstance(cdtype, str) and cdtype in (COMPLEX32, "c32"):
        return jnp.dtype(jnp.bfloat16)
    c = jnp.dtype(cdtype)
    if c == jnp.complex64:
        return jnp.dtype(jnp.float32)
    if c == jnp.complex128:
        return jnp.dtype(jnp.float64)
    raise ValueError(f"not a complex dtype: {cdtype}")


def complex_dtype_of(rdtype) -> jnp.dtype:
    r = jnp.dtype(rdtype)
    if r == jnp.float32:
        return jnp.dtype(jnp.complex64)
    if r == jnp.float64:
        return jnp.dtype(jnp.complex128)
    if r == jnp.bfloat16:  # upcast semantics for fallbacks/interop
        return jnp.dtype(jnp.complex64)
    raise ValueError(f"not a planar real dtype: {rdtype}")


def num_qubits(planar: jax.Array) -> int:
    assert planar.shape[0] == 2
    n = int(planar.shape[-1]).bit_length() - 1
    assert planar.shape[-1] == 1 << n
    return n


def to_complex(planar: jax.Array) -> jax.Array:
    """(2, dim) planes -> (dim,) complex (inside jit)."""
    return jax.lax.complex(planar[0], planar[1])


def from_complex(z: jax.Array) -> jax.Array:
    """(dim,) complex -> (2, dim) planes (inside jit)."""
    return jnp.stack([jnp.real(z), jnp.imag(z)])


def initial_planar(n: int, rdtype=jnp.float32, index: int = 1) -> jax.Array:
    """|00...01> as planes: Re at `index` is 1 (qc_shor.c:318-324; a layout
    may map the logical index 1 to a different physical position)."""
    return jnp.zeros((2, 1 << n), dtype=rdtype).at[0, index].set(1.0)


def initial_complex(n: int, rdtype=jnp.float32, index: int = 1):
    """|00...01> as a traced complex vector built from two SEPARATE
    (dim,)-shaped planes — never a stacked (2, dim) array.

    Use this inside reset-folded programs: the stacked (2, dim) reset
    would be one more state-sized buffer to build and slice, while
    real(complex(re, im)) -> re simplifies away, so this form adds zero
    traffic."""
    return jax.lax.complex(*initial_planes(n, rdtype, index))


def initial_planes(n: int, rdtype=jnp.float32, index: int = 1):
    """|00...01> as two SEPARATE (dim,) planes — the reset form for the
    planar-pair circuit path (no complex dtype, so it also serves the bf16
    "complex32" mode, which has no complex counterpart).  Built by an
    int32 iota compare: exact to n = 31 without 64-bit indices."""
    re = (jax.lax.iota(jnp.int32, 1 << n) == index).astype(rdtype)
    return re, jnp.zeros(1 << n, dtype=rdtype)


def zero_planar(n: int, rdtype=jnp.float32) -> jax.Array:
    """|00...0> as planes."""
    return jnp.zeros((2, 1 << n), dtype=rdtype).at[0, 0].set(1.0)


def probabilities(planar: jax.Array) -> jax.Array:
    if planar.dtype == jnp.bfloat16:  # bf16 is storage-only: sum in f32
        planar = planar.astype(jnp.float32)
    return planar[0] * planar[0] + planar[1] * planar[1]


def norm(planar: jax.Array) -> jax.Array:
    return jnp.sum(probabilities(planar))


def to_numpy_complex(planar) -> np.ndarray:
    """Host-side: planes -> numpy complex (fetches two real buffers)."""
    re = np.asarray(planar[0])
    im = np.asarray(planar[1])
    if re.dtype != np.float64:  # f32 and bf16 both widen to complex64 math
        re, im = re.astype(np.float32), im.astype(np.float32)
    return re + 1j * im  # numpy promotes f32 -> complex64, f64 -> complex128


def from_numpy_complex(z: np.ndarray, rdtype=None) -> jax.Array:
    """Host-side: numpy complex -> device planes (two real transfers)."""
    z = np.asarray(z)
    if rdtype is None:
        rdtype = jnp.float64 if z.dtype == np.complex128 else jnp.float32
    return jnp.stack([jnp.asarray(z.real, dtype=rdtype), jnp.asarray(z.imag, dtype=rdtype)])
