"""Self-consistency of the NumPy CPU oracle: the strided axis-contraction
gates must equal the reference's materialized Dirac-delta matrix
construction (qc_shor.c:442-565), and physics invariants must hold."""

import math

import numpy as np
import pytest

from quantumcomputer.sim import reference as ref
from tests.conftest import random_state


@pytest.mark.parametrize("n,q", [(3, 0), (3, 1), (3, 2), (5, 0), (5, 3), (5, 4)])
def test_apply_1q_matches_dense_matrix(n, q, rng):
    psi = random_state(n, rng)
    mat = ref.dense_gate_matrix_1q(ref.HADAMARD, q, n)
    np.testing.assert_allclose(ref.apply_hadamard(psi, q), mat @ psi, atol=1e-14)


@pytest.mark.parametrize("n,c,t", [(3, 2, 0), (3, 1, 0), (4, 3, 1), (5, 4, 2)])
def test_apply_cphase_matches_dense_matrix(n, c, t, rng):
    psi = random_state(n, rng)
    theta = 0.7331
    mat = ref.dense_gate_matrix_2q(ref.controlled_phase_matrix(theta), c, t, n)
    np.testing.assert_allclose(ref.apply_c_phase(psi, c, t, theta), mat @ psi, atol=1e-14)


@pytest.mark.parametrize("n,c,t", [(3, 2, 0), (4, 3, 1)])
def test_apply_2q_matches_dense_matrix(n, c, t, rng):
    psi = random_state(n, rng)
    u4 = ref.controlled_phase_matrix(1.234)
    mat = ref.dense_gate_matrix_2q(u4, c, t, n)
    np.testing.assert_allclose(ref.apply_2q(psi, u4, c, t), mat @ psi, atol=1e-14)


def test_camodc_is_permutation_when_coprime(rng):
    # C=15, A=7 coprime: gate must be a permutation (norm preserved exactly).
    psi = random_state(6, rng)  # M=4, control q=5
    out = ref.apply_c_amodc(psi, C=15, atox=7, c_q=5, M=4)
    assert abs(ref.norm(out) - 1.0) < 1e-14
    # Sorting both |amplitude| multisets of each control block must match.
    a = np.sort(np.abs(psi))
    b = np.sort(np.abs(out))
    np.testing.assert_allclose(a, b, atol=1e-14)


def test_camodc_matches_direct_matrix_semantics():
    # Build the permutation matrix exactly as qc_shor.c:608-657 and compare.
    C, A, M, L = 15, 7, 4, 2
    n = M + L
    c_q = 4
    dim = 1 << n
    mat = np.zeros((dim, dim), dtype=np.complex128)
    for k in range(dim):
        if (k >> c_q) & 1 == 0:
            mat[k, k] = 1.0
            continue
        f = k & ((1 << M) - 1)
        if f >= C:
            mat[k, k] = 1.0
            continue
        fp = (A * f) % C
        j = fp | (k & ~((1 << M) - 1))
        mat[j, k] = 1.0
    rng = np.random.default_rng(7)
    psi = random_state(n, rng)
    np.testing.assert_allclose(ref.apply_c_amodc(psi, C, A, c_q, M), mat @ psi, atol=1e-14)


def test_norm_conservation_through_full_circuit():
    # Report §IV.A: max norm deviation ~2.4e-15 while factoring 39 (L=6, M=6).
    psi = ref.shor_circuit(C=39, a=7, L=6, M=6)
    assert abs(ref.norm(psi) - 1.0) < 5e-14


def test_measure_index_inverse_cdf_semantics():
    # Hand-built state: probs [0.25, 0.5, 0.25] over 2 qubits (4th amp 0).
    psi = np.array([0.5, np.sqrt(0.5), 0.5, 0.0], dtype=np.complex128)
    assert ref.measure_index(psi, 0.0) == 0
    assert ref.measure_index(psi, 0.25) == 0  # cum[0]=0.25 >= r
    assert ref.measure_index(psi, 0.2500001) == 1
    assert ref.measure_index(psi, 0.75) == 1
    assert ref.measure_index(psi, 0.76) == 2
    # fall-through: r beyond total cumulative (reference loop falls to last)
    assert ref.measure_index(psi, 1.1) == 3


def test_read_omega_bit_reversal():
    # L=3, M=4 (N=7).  Measured index with L bits (q6,q5,q4) = (1,0,0):
    # x_tilde reads reversed: bit6 -> LSB => x_tilde = 0b001 = 1, omega=1/8.
    idx = 1 << 6
    assert ref.read_omega(idx, L=3, M=4) == 1 / 8
    # (q6,q5,q4) = (0,0,1) => x_tilde = 0b100 = 4, omega = 4/8.
    idx = 1 << 4
    assert ref.read_omega(idx, L=3, M=4) == 4 / 8
    # M bits must not contribute.
    assert ref.read_omega((1 << 4) | 0b1011, L=3, M=4) == 4 / 8


def test_initial_state():
    psi = ref.initial_state(5)
    assert psi[1] == 1.0 and ref.norm(psi) == 1.0
