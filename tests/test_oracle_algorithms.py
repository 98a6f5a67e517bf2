"""Bernstein-Vazirani / Deutsch-Jozsa: single-measurement DETERMINISM on
every engine — the simplest whole-stack correctness contract of the
generic layer (H sandwich + diagonal phase oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.oracle_algorithms import (
    bernstein_vazirani,
    bv_circuit,
    bv_oracle,
    deutsch_jozsa,
)
from quantumcomputer.sim.engine import Register, StateVectorEngine


@pytest.mark.parametrize("seed", range(5))
def test_bv_recovers_hidden_string(seed):
    rng = np.random.default_rng(seed)
    n = 8
    s = int(rng.integers(0, 1 << n))
    assert bernstein_vazirani(n, s, jax.random.PRNGKey(seed)) == s


def test_bv_validation():
    with pytest.raises(ValueError):
        bv_oracle(4, 16)


def test_bv_amplitude_is_exact():
    """The pre-measurement state IS |s>: amplitude 1 at s, 0 elsewhere."""
    n, s = 6, 0b101101
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex128)
    amps = eng.to_numpy(eng.run(bv_circuit(n, s), eng.zero_state()))
    want = np.zeros(1 << n, np.complex128)
    want[s] = 1.0
    np.testing.assert_allclose(amps, want, atol=1e-12)


def test_deutsch_jozsa_constant_vs_balanced():
    n = 7
    assert deutsch_jozsa(n, []) is True  # constant
    for s in (1, 0b1010101, (1 << n) - 1):
        assert deutsch_jozsa(n, bv_oracle(n, s)) is False  # balanced


def test_bv_on_sharded_engine():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    n, s = 8, 0b11001010  # hidden bits straddle global qubits
    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64, mesh=mesh)
    assert bernstein_vazirani(n, s, jax.random.PRNGKey(1), engine=eng) == s


def test_bv_on_pallas_engine():
    n, s = 14, 0b10011011001101
    eng = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    assert bernstein_vazirani(n, s, jax.random.PRNGKey(2), engine=eng) == s


def test_bv_dtype_matrix():
    """BV's determinism contract holds at every storage precision: bf16
    (complex32) and the dd64 double-float engine return the exact hidden
    string (amplitudes are exactly 0 or 1 — no rounding can flip them)."""
    from quantumcomputer.sim.dd_engine import DDStateVectorEngine

    n, s = 10, 0b1100110101
    eng32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")
    assert bernstein_vazirani(n, s, jax.random.PRNGKey(4), engine=eng32) == s
    eng_dd = DDStateVectorEngine(Register(L=n, M=0))
    assert bernstein_vazirani(n, s, jax.random.PRNGKey(5), engine=eng_dd) == s
