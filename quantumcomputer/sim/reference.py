"""NumPy CPU oracle: exact (corrected) Candela/qc_shor semantics.

This module is the *parity anchor* for the device engine: a slow, obviously
correct complex128 re-implementation of the reference program's quantum
semantics (qc_shor.c:370-737), used only in tests.  It follows the same
conventions:

  * basis-state index bit b == qubit b, LSB-first; the M (work) register is
    bits [0, M), the L (counting) register bits [M, N)  (qc_shor.c:608-657,
    720-722);
  * initial state |00...01> — amplitude 1 at index 1 (qc_shor.c:318-324);
  * Hadamard / controlled-phase built from the 2x2 / 4x4 base matrices with
    Dirac-delta selection over untouched qubits (qc_shor.c:442-565) — here
    realized as strided axis contractions, which is algebraically the same
    operator without materializing the 2^N x 2^N matrix;
  * the controlled a^x mod C gate as the permutation of qc_shor.c:595-660;
  * inverse-CDF measurement with a single uniform draw (qc_shor.c:272-306);
  * bit-reversed L-register readout of omega (qc_shor.c:868-883).
"""

from __future__ import annotations

import math
import numpy as np

SQRT1_2 = 1.0 / math.sqrt(2.0)

HADAMARD = np.array([[SQRT1_2, SQRT1_2], [SQRT1_2, -SQRT1_2]], dtype=np.complex128)


def controlled_phase_matrix(theta: float) -> np.ndarray:
    """4x4 controlled phase in the |control, target> basis (index = 2c + t),
    matching C_PHASE_SHIFT_BASE_MATRIX with the COMPLEX_ELEMENT slot filled
    by e^{i theta} (qc_shor.c:220-225, 553-555)."""
    m = np.eye(4, dtype=np.complex128)
    m[3, 3] = np.exp(1j * theta)
    return m


def initial_state(n: int) -> np.ndarray:
    """|00...01>: amplitude 1 at index 1 (qc_shor.c:318-324)."""
    psi = np.zeros(2**n, dtype=np.complex128)
    psi[1] = 1.0
    return psi


def apply_1q(psi: np.ndarray, u: np.ndarray, q: int) -> np.ndarray:
    """Apply 2x2 unitary u to qubit q of flat state psi.

    Index decomposition: s = o * 2^(q+1) + t * 2^q + i with t = bit q.
    """
    n_states = psi.shape[0]
    inner = 1 << q
    x = psi.reshape(n_states // (2 * inner), 2, inner)
    return np.einsum("ab,obi->oai", u, x).reshape(n_states)


def apply_2q(psi: np.ndarray, u4: np.ndarray, q_hi: int, q_lo: int) -> np.ndarray:
    """Apply 4x4 unitary u4 on (q_hi, q_lo), q_hi > q_lo, basis index 2*bit_hi + bit_lo."""
    assert q_hi > q_lo
    n_states = psi.shape[0]
    c = 1 << q_lo
    b = 1 << (q_hi - q_lo - 1)
    a = n_states // (4 * b * c)
    x = psi.reshape(a, 2, b, 2, c)
    u = u4.reshape(2, 2, 2, 2)  # (hi', lo', hi, lo)
    return np.einsum("efab,xaybc->xeyfc", u, x).reshape(n_states)


def apply_hadamard(psi: np.ndarray, q: int) -> np.ndarray:
    return apply_1q(psi, HADAMARD, q)


def apply_c_phase(psi: np.ndarray, c_q: int, t_q: int, theta: float) -> np.ndarray:
    """Controlled phase: diagonal — phase e^{i theta} where bits c_q and t_q are 1."""
    idx = np.arange(psi.shape[0], dtype=np.int64)
    mask = ((idx >> c_q) & 1) & ((idx >> t_q) & 1)
    return psi * np.where(mask == 1, np.exp(1j * theta), 1.0)


def modmul_permutation(C: int, A: int, M: int) -> np.ndarray:
    """Forward map g over the M register: f -> (A*f) mod C for f < C, identity
    for f >= C (qc_shor.c:608-657).  Returns g as an index array: new basis
    index g[f] receives the amplitude of f."""
    f = np.arange(1 << M, dtype=np.int64)
    g = np.where(f < C, (A % C) * f % C, f)
    return g


def apply_c_amodc(psi: np.ndarray, C: int, atox: int, c_q: int, M: int) -> np.ndarray:
    """Controlled modular-multiplication gate (qc_shor.c:595-660).

    Where control bit c_q == 1, permute the M register by f -> A*f mod C
    (A = atox mod C), identity elsewhere.  Implemented as a scatter
    new[g(k)] += old[k], which reproduces the reference's matrix semantics
    even when gcd(A, C) != 1 (non-unitary collision case).
    """
    n_states = psi.shape[0]
    A = atox % C
    g = modmul_permutation(C, A, M)
    k = np.arange(n_states, dtype=np.int64)
    ctrl = (k >> c_q) & 1
    m_mask = (1 << M) - 1
    j = np.where(ctrl == 1, (k & ~m_mask) | g[k & m_mask], k)
    out = np.zeros_like(psi)
    np.add.at(out, j, psi)
    return out


def inverse_qft(psi: np.ndarray, L: int, M: int) -> np.ndarray:
    """Gate-by-gate inverse QFT on the L register (qc_shor.c:678-690):
    for l = N-1 .. M: H(l), then controlled-phase(l, k, pi/2^(l-k)) for k < l."""
    for l in range(L + M - 1, M - 1, -1):
        psi = apply_hadamard(psi, l)
        for k in range(l - 1, M - 1, -1):
            psi = apply_c_phase(psi, l, k, math.pi / (1 << (l - k)))
    return psi


def shor_circuit(C: int, a: int, L: int, M: int) -> np.ndarray:
    """The full fixed period-finding circuit (qc_shor.c:712-737):
    H on each L qubit -> controlled a^(2^j) mod C ladder -> inverse QFT."""
    n = L + M
    psi = initial_state(n)
    for l in range(M, n):
        psi = apply_hadamard(psi, l)
    for j, l in enumerate(range(M, n)):
        atox = pow(a, 1 << j, C)  # exact, vs the reference's double INT_POW
        psi = apply_c_amodc(psi, C, atox, l, M)
    return inverse_qft(psi, L, M)


def measure_index(psi: np.ndarray, r: float) -> int:
    """Inverse-CDF measurement with uniform draw r (qc_shor.c:272-306):
    the smallest index with cumulative probability >= r, falling through to
    the last index."""
    probs = np.abs(psi) ** 2
    cum = np.cumsum(probs)
    hits = np.nonzero(cum[:-1] >= r)[0]
    return int(hits[0]) if hits.size else psi.shape[0] - 1


def collapse(psi: np.ndarray, index: int) -> np.ndarray:
    out = np.zeros_like(psi)
    out[index] = 1.0
    return out


def read_omega(state_num: int, L: int, M: int) -> float:
    """Bit-reversed readout of the L register (qc_shor.c:868-883):
    bit N-1 of the measured index becomes the LSB of x_tilde.

    Deliberately a DIFFERENT realization from the production
    algorithms/shor.py::read_omega (string reversal vs bit loop), so the
    parity tests comparing them are not vacuous."""
    counting = (state_num >> M) & ((1 << L) - 1)
    x_tilde = int(format(counting, f"0{L}b")[::-1], 2)
    return x_tilde / float(1 << L)


def norm(psi: np.ndarray) -> float:
    return float(np.sum(np.abs(psi) ** 2))


def dense_gate_matrix_1q(u: np.ndarray, q: int, n: int) -> np.ndarray:
    """Materialized 2^n x 2^n one-qubit gate via the reference's Dirac-delta
    construction (qc_shor.c:456-481) — used only to cross-check apply_1q."""
    dim = 1 << n
    mat = np.zeros((dim, dim), dtype=np.complex128)
    other = ~np.int64(1 << q)
    for i in range(dim):
        for j in range(dim):
            if (i & other) == (j & other):
                mat[i, j] = u[(i >> q) & 1, (j >> q) & 1]
    return mat


def dense_gate_matrix_2q(u4: np.ndarray, c_q: int, t_q: int, n: int) -> np.ndarray:
    """Materialized two-qubit gate via the reference construction
    (qc_shor.c:528-562), base index 2*bit(c_q) + bit(t_q)."""
    dim = 1 << n
    mat = np.zeros((dim, dim), dtype=np.complex128)
    other = ~np.int64((1 << c_q) | (1 << t_q))
    for i in range(dim):
        for j in range(dim):
            if (i & other) == (j & other):
                bi = 2 * ((i >> c_q) & 1) + ((i >> t_q) & 1)
                bj = 2 * ((j >> c_q) & 1) + ((j >> t_q) & 1)
                mat[i, j] = u4[bi, bj]
    return mat
