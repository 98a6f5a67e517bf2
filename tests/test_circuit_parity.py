"""Full-circuit amplitude parity: the jitted device engine vs the NumPy
oracle on complete Shor period-finding circuits, <=1e-12 in complex128 —
the north-star parity target (BASELINE.md)."""

import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_reference
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine

CASES = [
    (15, 7, 3, 4),   # the Report TABLE I configuration
    (15, 13, 3, 4),
    (21, 2, 4, 5),   # Report §IV.C configuration
    (21, 5, 4, 5),
    (33, 7, 5, 6),   # usage example qc_shor.c:26-29 (M>=6 for 2^M>=33)
]


@pytest.mark.parametrize("C,a,L,M", CASES)
def test_shor_circuit_amplitude_parity(C, a, L, M):
    want = ref.shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    got = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("C,a,L,M", CASES[:2])
def test_fused_equals_reference_sequence(C, a, L, M):
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    fused = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    refseq = eng.to_numpy(eng.run(shor_circuit_reference(C, a, L, M)))
    np.testing.assert_allclose(fused, refseq, atol=1e-13)


def test_norm_trace_regression():
    """Report §IV.A / FIG. 2 analog: norm deviation stays <= ~1e-14 in c128
    through every gate of factoring 39 (L=6, M=6)."""
    C, a, L, M = 39, 7, 6, 6
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    _, norms = eng.run_with_norms(shor_circuit_reference(C, a, L, M))
    devs = np.abs(np.asarray(norms) - 1.0)
    assert devs.max() < 1e-13, f"max norm deviation {devs.max():.3e}"


def test_norm_trace_fused_production_path():
    """FIG. 2 regression on the production path: the engine's default
    fusion (the oracle run composed into ladders at this size), one norm
    per executed gate, on the 39-factorization circuit family
    (qc_shor.c:78-79) with a widened L."""
    from quantumcomputer.sim.engine import fuse_oracle_ladders

    C, a, L, M = 39, 7, 8, 6
    circ = shor_circuit(C, a, L, M)
    executed = fuse_oracle_ladders(circ, M)
    assert len(executed) < len(circ), "the oracle run must compose into ladders"
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    _, norms = eng.run_with_norms(circ)
    assert norms.shape[0] == len(executed), "one norm per executed gate"
    devs = np.abs(np.asarray(norms) - 1.0)
    assert devs.max() < 1e-6, f"max norm deviation {devs.max():.3e}"


def test_norm_trace_c128_per_gate_granularity():
    """fuse=False xla/c128 mode keeps the reference's per-gate granularity."""
    C, a, L, M = 39, 7, 6, 6
    circ = shor_circuit_reference(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, fuse=False)
    _, norms = eng.run_with_norms(circ)
    assert norms.shape[0] == len(circ)
    assert np.abs(np.asarray(norms) - 1.0).max() < 1e-13


def test_nan_check_hook(capfd):
    """nan_checks=True prints from inside the compiled program when the
    state goes non-finite (and stays silent on healthy circuits)."""
    import jax

    from quantumcomputer.sim import statevec as sv

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128, nan_checks=True)
    state = eng.run(shor_circuit(15, 7, 3, 4))
    jax.effects_barrier()
    assert "non-finite" not in capfd.readouterr().out
    bad = np.asarray(eng.initial_state()).copy()
    bad[0, 0] = np.nan
    out_state = eng.run(shor_circuit(15, 7, 3, 4), jnp.asarray(bad))
    out_state.block_until_ready()
    jax.effects_barrier()
    assert "non-finite" in capfd.readouterr().out


def test_complex64_norm_envelope():
    """Throughput dtype: norm must still hold to f32 round-off."""
    C, a, L, M = 21, 2, 4, 5
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    state = eng.run(shor_circuit(C, a, L, M))
    assert abs(eng.norm(state) - 1.0) < 1e-5


def test_complex64_amplitude_accuracy():
    C, a, L, M = 15, 7, 3, 4
    want = ref.shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64)
    got = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    np.testing.assert_allclose(got, want, atol=5e-6)
