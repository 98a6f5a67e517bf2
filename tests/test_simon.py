"""Simon's algorithm: oracle promise, orthogonal sampling, GF(2) solve,
end-to-end recovery on every engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.algorithms.simon import (
    SimonResult,
    _gf2_nullspace,
    simon_circuit,
    simon_oracle,
    simon_search,
)
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _f_of(n, s):
    k = (s & -s).bit_length() - 1
    return lambda x: x ^ (s if (x >> k) & 1 else 0)


@pytest.mark.parametrize("n,s", [(4, 0b1010), (5, 0b00001), (6, 0b110110)])
def test_oracle_implements_promise(n, s):
    """Classical check of the CNOT network: simulate it on basis states and
    verify f(x) = f(x') iff x' in {x, x^s}."""
    f = _f_of(n, s)
    # the CNOT list computes y ^= f(x) when applied to bits
    gates = simon_oracle(n, s)
    for x in range(1 << n):
        y = 0
        for g in gates:
            c, t = g.qubits
            if (x >> (c - n)) & 1:
                y ^= 1 << t
        assert y == f(x), (x, y, f(x))
    vals = {}
    for x in range(1 << n):
        vals.setdefault(f(x), []).append(x)
    for xs in vals.values():
        assert len(xs) == 2 and xs[0] ^ xs[1] == s


def test_sampled_z_orthogonal_and_uniform():
    """Every pre-measurement amplitude sits on z . s = 0 (exact)."""
    n, s = 4, 0b0110
    eng = StateVectorEngine(Register(L=n, M=n), dtype=jnp.complex128)
    amps = eng.to_numpy(eng.run(simon_circuit(n, s), eng.zero_state()))
    probs = np.abs(amps) ** 2
    for idx in np.nonzero(probs > 1e-15)[0]:
        z = (int(idx) >> n) & ((1 << n) - 1)
        assert bin(z & s).count("1") % 2 == 0


def test_gf2_nullspace():
    # s = 0b101: both rows orthogonal to it (010.101 = 0; 111.101 = 2 = 0 mod 2)
    rows = [0b010, 0b111]
    assert _gf2_nullspace(rows, 3) == 0b101
    assert _gf2_nullspace([0b010], 3) is None  # rank deficient


@pytest.mark.parametrize("seed,n,s", [(0, 5, 0b10110), (1, 6, 0b000011), (2, 4, 0b1000)])
def test_simon_end_to_end(seed, n, s):
    res = simon_search(n, s, jax.random.PRNGKey(seed))
    assert isinstance(res, SimonResult)
    assert res.s == s
    assert all(bin(z & s).count("1") % 2 == 0 for z in res.equations)


def test_simon_on_sharded_engine():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer import ShardedStateVectorEngine, build_mesh

    n, s = 4, 0b1011
    mesh = build_mesh(num_devices=4)
    eng = ShardedStateVectorEngine(Register(L=n, M=n), dtype=jnp.complex64, mesh=mesh)
    assert simon_search(n, s, jax.random.PRNGKey(3), engine=eng).s == s


def test_simon_validation():
    with pytest.raises(ValueError):
        simon_oracle(4, 0)
    with pytest.raises(ValueError):
        simon_oracle(4, 16)


def test_simon_complex128_and_rounds_metric():
    res = simon_search(5, 0b01010, jax.random.PRNGKey(9), dtype=jnp.complex128)
    assert res.s == 0b01010
    # rounds counts quantum samples (>= number of equations kept)
    assert res.rounds >= len(res.equations) >= 4
