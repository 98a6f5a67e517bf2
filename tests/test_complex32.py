"""complex32 (bf16-storage) throughput mode.

Storage-only bf16: every gate upcasts to f32, computes at full f32
precision, and rounds to bf16 only on the store — so per-pass error is
one bf16 rounding (~2^-8 relative) and full-circuit amplitude error stays
in the 1e-3..1e-2 envelope.  No complex dtype exists at this width, so the
mode exercises the planar-pair circuit path end to end
(sim/engine.apply_circuit_planes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumcomputer.models.circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _amps(state) -> np.ndarray:
    re = np.asarray(state[0].astype(jnp.float32), np.float64)
    im = np.asarray(state[1].astype(jnp.float32), np.float64)
    return re + 1j * im


def test_c32_mhigh_shor_parity_vs_c64():
    """Full m_high Shor circuit (fused kernels + DMA oracle) at bf16
    storage tracks the c64 amplitudes to the documented envelope."""
    C, a, L, M = 33, 29, 8, 6
    circ = shor_circuit_mhigh(C, a, L, M)
    e64 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    e32 = StateVectorEngine(Register(L=L, M=M), dtype="complex32", layout="m_high")
    a64 = _amps(e64.run(circ))
    a32 = _amps(e32.run(circ))
    assert np.abs(a64 - a32).max() < 2e-3
    assert abs(np.vdot(a32, a32).real - 1.0) < 5e-3


def test_c32_generic_circuit_parity_vs_c64():
    """Standard-layout dense mix (fused planner + XLA fallback gates)."""
    n = 14
    circ = tuple(cir.RY(q, 0.1 + 0.03 * q) for q in range(n)) + (
        cir.H(3),
        cir.CNOT(13, 2),
        cir.CPHASE(12, 1, 0.7),
        cir.H(13),
    )
    e64 = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    e32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")
    a64 = _amps(e64.run(circ, e64.zero_state()))
    a32 = _amps(e32.run(circ, e32.zero_state()))
    # This mix concentrates ~0.47 of amplitude on one state; the bound is a
    # few bf16 ulps of that (storage rounding after every gate), i.e.
    # RELATIVE ~2^-8 — not the small-amplitude 2e-4 envelope.
    assert np.abs(a64 - a32).max() < 5e-3


def test_c32_norm_and_measure_programs():
    """Reset-folded scalar-output programs (the production path at the
    memory ceiling) work at bf16: norm ~ 1 and the measured index is a
    valid basis state with nonzero c64 probability."""
    C, a, L, M = 33, 29, 8, 6
    circ = shor_circuit_mhigh(C, a, L, M)
    e32 = StateVectorEngine(Register(L=L, M=M), dtype="complex32", layout="m_high")
    assert abs(e32.run_norm(circ) - 1.0) < 5e-3
    idx = e32.run_and_measure_index(circ, jax.random.PRNGKey(3))
    assert 0 <= idx < (1 << (L + M))
    e64 = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, layout="m_high")
    p64 = np.abs(_amps(e64.run(circ))) ** 2
    assert p64[idx] > 1e-6  # never lands on a zero-probability state


def test_c32_sampling_statistics():
    """Non-collapsing sampler on bf16 planes: f32-accumulated hierarchical
    reduction reproduces a known two-peak distribution."""
    n = 16
    e32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")
    # H on the top qubit: exactly two equal peaks at 0 and 2^(n-1).
    state = e32.run((cir.H(n - 1),), e32.zero_state())
    idxs = np.asarray(e32.sample(state, jax.random.PRNGKey(0), 256))
    vals, counts = np.unique(idxs, return_counts=True)
    assert set(vals) <= {0, 1 << (n - 1)}
    assert counts.min() > 64  # ~128 +- binomial noise


def test_c32_is_a_storage_format():
    """complex32 keeps bf16 planes in memory and computes each gate in f32:
    the engine's states are bf16, and the planner counts f32 bytes for
    two-state programs."""
    from quantumcomputer.sim.engine import compute_plane_dtype

    eng = StateVectorEngine(Register(L=4, M=4), dtype="complex32")
    assert eng.real_dtype == jnp.bfloat16
    assert eng.initial_state().dtype == jnp.bfloat16
    assert compute_plane_dtype(eng.real_dtype) == jnp.float32
    out = eng.run((cir.H(7), cir.RY(2, 0.4)), eng.initial_state())
    assert out.dtype == jnp.bfloat16 and out.shape == (2, 1 << 8)


def test_c32_backprop_adjoint():
    """The O(1)-memory adjoint VJP runs on bf16 planes (planar-pair adjoint
    circuit, no complex dtype)."""
    n = 13
    circ = (cir.H(12), cir.RY(5, 0.3), cir.H(0))
    e32 = StateVectorEngine(Register(L=n, M=0), dtype="complex32")

    def loss(planar):
        out = e32._compiled_run(circ, with_norms=False)(planar)
        return jnp.sum(out[0].astype(jnp.float32) ** 2)

    g = jax.grad(loss)(e32.zero_state())
    assert g.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(g.astype(jnp.float32)).all())


def test_c32_norm_trace_and_nan_hooks():
    """run_with_norms on bf16 planes: f32-accumulated per-segment norms on
    the production path stay within the storage envelope; nan_checks
    traces without error."""
    C, a, L, M = 33, 29, 8, 6
    circ = shor_circuit_mhigh(C, a, L, M)
    e32 = StateVectorEngine(
        Register(L=L, M=M), dtype="complex32", layout="m_high", nan_checks=True
    )
    _, norms = e32.run_with_norms(circ, e32.initial_state())
    norms = np.asarray(norms, np.float64)
    assert norms.shape[0] >= 3
    assert np.abs(norms - 1.0).max() < 5e-3
