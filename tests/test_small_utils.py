"""Direct pins for the small public utilities (previously only exercised
indirectly or not at all)."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms import number_theory as nt
from quantumcomputer.ops import dd, gates
from quantumcomputer.sim import statevec as sv


def test_is_prime():
    primes = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 8191, 1021}
    for n in range(-3, 30):
        assert nt.is_prime(n) == (n in primes)
    assert nt.is_prime(8191) and not nt.is_prime(8189)  # 8189 = 431*19


def test_prime_c_warning():
    from quantumcomputer.algorithms.shor import issue_warnings

    assert any("prime" in w for w in issue_warnings(1021, 20, 10))
    assert any("even" in w for w in issue_warnings(1022, 20, 10))
    assert not any("prime" in w or "even" in w for w in issue_warnings(1023, 20, 10))


def test_apply_permutation():
    state = jnp.arange(8).astype(jnp.complex64)
    perm_inv = jnp.asarray([1, 0, 3, 2, 5, 4, 7, 6])
    out = np.asarray(gates.apply_permutation(state, perm_inv))
    np.testing.assert_array_equal(out.real, [1, 0, 3, 2, 5, 4, 7, 6])


def test_dtype_roundtrip():
    assert sv.complex_dtype_of(jnp.float32) == jnp.dtype(jnp.complex64)
    assert sv.complex_dtype_of(jnp.float64) == jnp.dtype(jnp.complex128)
    assert sv.real_dtype_of(jnp.complex64) == jnp.dtype(jnp.float32)


def test_num_qubits_of():
    assert gates.num_qubits_of(jnp.zeros(16, jnp.complex64)) == 4
    with pytest.raises(AssertionError):
        gates.num_qubits_of(jnp.zeros(6, jnp.complex64))


def test_dd_from_f32():
    hi, lo = dd.from_f32(jnp.asarray([1.5, -2.0], jnp.float32))
    np.testing.assert_array_equal(np.asarray(hi), [1.5, -2.0])
    np.testing.assert_array_equal(np.asarray(lo), [0.0, 0.0])
    # composes with dd arithmetic: (x, 0) + (y, 0) == exact f32 sum pair
    s_hi, s_lo = dd.add(dd.from_f32(jnp.float32(1.0)), dd.from_f32(jnp.float32(2**-30)))
    assert float(s_hi) + float(s_lo) == 1.0 + 2**-30
