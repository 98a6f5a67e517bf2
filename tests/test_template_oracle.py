"""Compile-once trial loop: slot-oracle template circuits.

The unforced trial loop would otherwise compile a fresh XLA program per
trial integer (each a changes the oracle constants baked into the circuit);
the template form carries the permutation tables as program OPERANDS, so
one compiled program serves every a (models/shor_circuit.shor_circuit_template,
engine.run_and_measure_index_with_tables).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.shor_circuit import (
    shor_circuit,
    shor_circuit_mhigh,
    shor_circuit_template,
    shor_oracle_tables,
)
from quantumcomputer.sim.engine import Register, StateVectorEngine


@pytest.mark.parametrize("layout,dtype", [
    ("standard", jnp.complex64), ("standard", "complex32"), ("m_high", jnp.complex64),
])
def test_template_matches_static_circuit(layout, dtype):
    """Same key -> same measured index as the constant-baked circuit, for
    several trial integers through ONE cached template program."""
    C, L, M = 33, 5, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=dtype, layout=layout)
    template = shor_circuit_template(L, M, layout)
    build = shor_circuit_mhigh if layout == "m_high" else shor_circuit
    for a in (2, 5, 7):
        key = jax.random.PRNGKey(a)
        tables = shor_oracle_tables(C, a, L, M)
        idx_dyn = eng.run_and_measure_index_with_tables(template, tables, key)
        idx_static = eng.run_and_measure_index(build(C, a, L, M), key)
        assert idx_dyn == idx_static, f"a={a}"


def test_template_compiles_once_across_trial_integers():
    """The cache holds ONE template program after multiple a's (the whole
    point: per-a cost is an execute, not a compile)."""
    C, L, M = 33, 4, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    template = shor_circuit_template(L, M)
    for a in (2, 5, 7, 10):
        eng.run_and_measure_index_with_tables(
            template, shor_oracle_tables(C, a, L, M), jax.random.PRNGKey(a)
        )
    dyn_keys = [
        k for k in eng._run_cache
        if isinstance(k, tuple) and "measure_idx_dyn" in k and k[-1] > 0
    ]
    assert len(dyn_keys) == 1


def test_unforced_driver_uses_template_and_factors():
    """End-to-end unforced factoring goes through the template path
    (asserted via the engine's program cache) and produces correct
    factors."""
    from quantumcomputer.algorithms.shor import shors_algorithm

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    res = shors_algorithm(C=15, L=3, M=4, seed=11, engine=eng)
    assert res.ok and res.factors is not None
    f0, f1 = res.factors
    assert f0 * f1 == 15 and {f0, f1} == {5, 3}
    assert any(
        isinstance(k, tuple) and "measure_idx_dyn" in k and k[-1] > 0
        for k in eng._run_cache
    ), "unforced run did not take the template path"


def test_template_skipped_at_memory_ceiling(monkeypatch):
    """allow_template is ignored when two state buffers would not fit (the
    slot oracle's XLA gather is out-of-place): find_period falls back to
    the static in-place path."""
    import quantumcomputer.algorithms.shor as shor_mod
    from quantumcomputer.algorithms.shor import find_period

    calls = {"dyn": 0}
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    orig = eng.run_and_measure_index_with_tables

    def spy(circuit, tables, key):
        if len(tables) > 0:  # the static path delegates here with tables=()
            calls["dyn"] += 1
        return orig(circuit, tables, key)

    eng.run_and_measure_index_with_tables = spy
    import quantumcomputer.sim.engine as eng_mod

    monkeypatch.setenv("QC_HBM_BYTES", "1")
    rec = find_period(eng, 15, 7, jax.random.PRNGKey(0), allow_template=True)
    assert calls["dyn"] == 0 and rec.period == 4

    monkeypatch.setenv("QC_HBM_BYTES", str(int(14.5 * (1 << 30))))
    rec = find_period(eng, 15, 7, jax.random.PRNGKey(0), allow_template=True)
    assert calls["dyn"] == 1 and rec.period == 4


def test_template_works_at_complex32():
    """The bf16 planar-pair path also binds slot-oracle tables.  Uses
    (C=15, a=7): period 4 divides 2^L, so the omega distribution is four
    EXACT point masses and bf16 storage noise cannot move any inverse-CDF
    draw across an index boundary."""
    C, a, L, M = 15, 7, 3, 4
    e32 = StateVectorEngine(Register(L=L, M=M), dtype="complex32")
    e64 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    template = shor_circuit_template(L, M)
    tables = shor_oracle_tables(C, a, L, M)
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        idx32 = e32.run_and_measure_index_with_tables(template, tables, key)
        idx64 = e64.run_and_measure_index_with_tables(template, tables, key)
        assert idx32 == idx64
