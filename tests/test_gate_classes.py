"""Every gate class of the XLA path, at every stride class, vs the
complex128 reference (sim/reference.py), in complex64 and complex32.

ops/gates.py picks a form by state size and target stride: the einsum
form below _SMALL_DIM, the wide slice/concat (q >= 6) and lane-roll
(q < 6) butterflies above it, the roll-based dense 2q form, the fused
inverse-QFT stage and the modular-multiply gathers.  These are the forms
that run on the device, so each is pinned per stride class here.
complex32 keeps bf16 planes and computes each gate in f32: its results
are held to the bf16 storage envelope instead of f32 roundoff.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models import circuit as cir
from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.ops import gates as xops
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine
from tests.conftest import random_state

N = 16  # dim 65536 >= _SMALL_DIM: the large-state forms
DTYPES = ["complex64", "complex32"]
ATOL = 3e-5  # complex64: f32 roundoff over a few passes
C32_NORM_TOL = 1e-2  # complex32: ||got - want|| within the bf16 envelope


def _u2(rng):
    return np.linalg.qr(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))[0]


def _u4(rng):
    return np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]


def run_engine(psi, gates, dtype="complex64", M=0, fuse=True):
    n = int(psi.shape[0]).bit_length() - 1
    jdt = jnp.complex64 if dtype == "complex64" else "complex32"
    eng = StateVectorEngine(Register(L=n - M, M=M), dtype=jdt, fuse=fuse)
    s0 = jnp.stack([jnp.asarray(psi.real), jnp.asarray(psi.imag)]).astype(eng.real_dtype)
    return eng.to_numpy(eng.run(tuple(gates), s0))


def reference(psi, gates, M=0):
    want = psi.copy()
    for g in gates:
        if g.name == "iqft_stage":
            l = g.qubits[0]
            want = ref.apply_hadamard(want, l)
            for k in range(l - 1, M - 1, -1):
                want = ref.apply_c_phase(want, l, k, math.pi / (1 << (l - k)))
        elif g.name == "camodc":
            want = ref.apply_c_amodc(want, g.meta[0], g.meta[1], g.qubits[0], M)
        elif len(g.qubits) == 1:
            want = ref.apply_1q(want, cir.gate_matrix_1q(g), g.qubits[0])
        else:
            m = cir.gate_matrix_2q(g)
            q_hi, q_lo = g.qubits
            if q_hi < q_lo:
                q_hi, q_lo = q_lo, q_hi
                p = [0, 2, 1, 3]
                m = m[np.ix_(p, p)]
            want = ref.apply_2q(want, m, q_hi, q_lo)
    return want


def check(got, want, dtype):
    if dtype == "complex64":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        assert np.linalg.norm(got - want) < C32_NORM_TOL, np.linalg.norm(got - want)


# -- dense 1q -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", [0, 1, 3, 6, 7, 9, 10, 12, 13])
def test_1q_hadamard_all_strides(q, dtype, rng):
    psi = random_state(N, rng)
    gates = (cir.H(q),)
    check(run_engine(psi, gates, dtype), reference(psi, gates), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", [2, 5, 8, 9, 10, 15])
def test_1q_complex_unitary(q, dtype, rng):
    psi = random_state(N, rng)
    gates = (cir.U1Q(q, _u2(rng)),)
    check(run_engine(psi, gates, dtype), reference(psi, gates), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "qubits",
    [
        (0, 3, 5),               # lane-roll strides
        (7, 9, 12),              # wide strides
        (13, 14, 15),            # top strides
        (2, 8, 13),              # one of each
        (15, 0, 10, 14, 5, 13),  # interleaved
    ],
)
def test_1q_hadamard_runs(qubits, dtype, rng):
    psi = random_state(N, rng)
    gates = [cir.H(q) for q in qubits]
    check(run_engine(psi, gates, dtype), reference(psi, gates), dtype)


def test_1q_dense_complex_unitaries(rng):
    psi = random_state(N, rng)
    gates = [cir.U1Q(q, _u2(rng)) for q in (1, 8, 13, 15, 4, 11)]
    check(run_engine(psi, gates), reference(psi, gates), "complex64")


def test_small_register_einsum_path():
    # n=7 < _SMALL_DIM: every gate takes the einsum form.
    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex64)
    got = eng.to_numpy(eng.run(shor_circuit(15, 7, 3, 4)))
    np.testing.assert_allclose(got, ref.shor_circuit(15, 7, 3, 4), atol=5e-6)


def test_wide_and_roll_paths_match_einsum(rng):
    """The large-state XLA forms (wide slice/concat, lane roll) equal the
    reference at complex128 roundoff."""
    psi = random_state(14, rng)  # dim 16384 >= _SMALL_DIM: wide/roll paths
    z = jnp.asarray(psi)
    u = _u2(rng)
    for q in (0, 3, 5, 6, 9, 13):
        got = np.asarray(xops.apply_1q(z, jnp.asarray(u), q))
        np.testing.assert_allclose(got, ref.apply_1q(psi, u, q), atol=1e-12, err_msg=f"q={q}")
    for l, M in ((13, 4), (9, 2), (6, 0)):
        got = np.asarray(xops.apply_iqft_stage(z, l, M))
        want = np.asarray(ref.apply_hadamard(psi, l))
        for k in range(l - 1, M - 1, -1):
            want = ref.apply_c_phase(want, l, k, np.pi / (1 << (l - k)))
        np.testing.assert_allclose(got, want, atol=1e-12, err_msg=f"l={l},M={M}")


# -- diagonal -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_diagonal_gates_mix(dtype, rng):
    psi = random_state(N, rng)
    gates = [
        cir.H(14),
        cir.PHASE(15, 0.37),
        cir.Z(3),
        cir.RZ(9, 1.21),
        cir.CPHASE(15, 2, 0.81),
        cir.CPHASE(9, 8, 0.44),
        cir.CZ(13, 12),
        cir.H(13),
        cir.CPHASE(14, 13, 0.29),
        cir.T(0),
        cir.S(7),
    ]
    check(run_engine(psi, gates, dtype), reference(psi, gates), dtype)


# -- dense 2q -------------------------------------------------------------------

# (q_hi, q_lo) over the stride classes at n=15: lane-roll (< 6), wide
# (6..12), top (13, 14).
PAIRS = [(5, 2), (9, 3), (11, 8), (13, 4), (14, 10), (14, 13)]


@pytest.mark.parametrize("q_hi,q_lo", PAIRS)
@pytest.mark.parametrize("kind", ["u2q", "cnot", "swap"])
def test_2q_all_stride_pairs(q_hi, q_lo, kind, rng):
    g = {
        "u2q": lambda: cir.U2Q(q_hi, q_lo, _u4(rng)),
        "cnot": lambda: cir.CNOT(q_hi, q_lo),
        "swap": lambda: cir.SWAP(q_hi, q_lo),
    }[kind]()
    psi = random_state(15, rng)
    check(run_engine(psi, (g,)), reference(psi, (g,)), "complex64")


@pytest.mark.parametrize("q_hi,q_lo", PAIRS)
def test_2q_complex32(q_hi, q_lo, rng):
    psi = random_state(15, rng)
    gates = (cir.U2Q(q_hi, q_lo, _u4(rng)),)
    check(run_engine(psi, gates, "complex32"), reference(psi, gates), "complex32")


@pytest.mark.parametrize("q_hi,q_lo", [(4, 1), (12, 7)])
def test_2q_low_high_qubit_order(q_hi, q_lo, rng):
    """Gates listing qubits low-before-high relabel the 4x4 correctly."""
    psi = random_state(14, rng)
    gates = (cir.U2Q(q_lo, q_hi, _u4(rng)),)
    check(run_engine(psi, gates), reference(psi, gates), "complex64")


def test_2q_in_mixed_run(rng):
    n = 15
    gates = (
        cir.H(14), cir.RY(13, 0.3),
        cir.CNOT(5, 2), cir.SWAP(11, 8), cir.U2Q(14, 10, _u4(rng)),
        cir.H(3), cir.RZ(9, 0.4),
    )
    psi = random_state(n, rng)
    check(run_engine(psi, gates), reference(psi, gates), "complex64")


def test_2q_in_sharded_local_path(rng):
    """Shard-local dense 2q gates inside shard_map match the single
    device."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from quantumcomputer.parallel.mesh import build_mesh
    from quantumcomputer.parallel.sharded import ShardedStateVectorEngine

    n = 16
    circ = (cir.H(15), cir.CNOT(13, 2), cir.U2Q(11, 7, _u4(rng)), cir.H(3))
    single = StateVectorEngine(Register(L=n, M=0), dtype=jnp.complex64)
    multi = ShardedStateVectorEngine(
        Register(L=n, M=0), dtype=jnp.complex64, mesh=build_mesh(num_devices=4)
    )
    psi = random_state(n, rng)
    s0 = jnp.stack([jnp.asarray(psi.real, jnp.float32), jnp.asarray(psi.imag, jnp.float32)])
    a = single.to_numpy(single.run(circ, s0 + 0))
    b = multi.to_numpy(multi.run(circ, jax.device_put(s0, multi.sharding)))
    np.testing.assert_allclose(a, b, atol=2e-6)


# -- inverse-QFT stages -----------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,M", [(15, 4), (13, 8), (12, 3), (11, 10), (9, 9), (6, 0), (5, 0)])
def test_iqft_stage(l, M, dtype, rng):
    psi = random_state(N, rng)
    gates = (cir.Gate("iqft_stage", (l,)),)
    check(run_engine(psi, gates, dtype, M=M), reference(psi, gates, M=M), dtype)


@pytest.mark.parametrize("M", [8, 3])
def test_full_iqft(M, rng):
    psi = random_state(N, rng)
    gates = [cir.Gate("iqft_stage", (l,)) for l in range(N - 1, M - 1, -1)]
    check(run_engine(psi, gates, M=M), reference(psi, gates, M=M), "complex64")


def test_iqft_stage_interleaved_dense(rng):
    """A dense gate on a stage's own bit between two stages keeps its
    order."""
    psi = random_state(N, rng)
    gates = [
        cir.Gate("iqft_stage", (10,)), cir.RY(10, 0.7),
        cir.Gate("iqft_stage", (9,)), cir.H(3),
    ]
    check(run_engine(psi, gates), reference(psi, gates), "complex64")


# -- modular-multiply gather (standard layout) ------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,A,M,c_q", [(15, 7, 4, 9), (15, 13, 4, 15), (33, 29, 6, 13), (251, 13, 8, 14)])
def test_camodc_oracle(C, A, M, c_q, dtype, rng):
    psi = random_state(N, rng)
    gates = (cir.CAMODC(C, A, c_q),)
    check(run_engine(psi, gates, dtype, M=M), reference(psi, gates, M=M), dtype)


def test_camodc_in_mixed_run(rng):
    # The Shor pattern: H layer interleaved with the modexp oracles, which
    # the engine composes into one ladder.
    C, a, M = 33, 7, 6
    psi = random_state(N, rng)
    gates = []
    for j, hq in enumerate((13, 14, 15, 7)):
        gates.append(cir.H(hq))
        gates.append(cir.CAMODC(C, pow(a, 1 << j, C), M + j))
    check(run_engine(psi, gates, M=M), reference(psi, gates, M=M), "complex64")


# -- whole circuits -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_shor_circuit(dtype):
    """A full Shor circuit (n=15: C=33, L=9, M=6) vs the reference."""
    C, a, L, M = 33, 7, 9, 6
    jdt = jnp.complex64 if dtype == "complex64" else "complex32"
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jdt)
    got = eng.to_numpy(eng.run(shor_circuit(C, a, L, M)))
    check(got, ref.shor_circuit(C, a, L, M), dtype)
    assert abs(np.sum(np.abs(got) ** 2) - 1) < (1e-4 if dtype == "complex64" else 1e-2)


def test_fuse_off_matches_fuse_on():
    C, a, L, M = 33, 7, 9, 6
    circ = shor_circuit(C, a, L, M)
    e_on = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, fuse=True)
    e_off = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex64, fuse=False)
    np.testing.assert_allclose(
        e_on.to_numpy(e_on.run(circ)), e_off.to_numpy(e_off.run(circ)), atol=2e-5
    )


def test_random_circuit_vs_reference(rng):
    """A random dense/diagonal circuit vs CPU linear algebra (n=14)."""
    n = 14
    psi = random_state(n, rng)
    gates = []
    names_1q = ["h", "x", "y", "z", "phase", "rx", "ry", "rz"]
    for _ in range(40):
        if rng.random() < 0.75:
            q = int(rng.integers(n))
            nm = names_1q[int(rng.integers(len(names_1q)))]
            params = (float(rng.random() * 3),) if nm in ("phase", "rx", "ry", "rz") else ()
            gates.append(cir.Gate(nm, (q,), params))
        else:
            q0, q1 = map(int, rng.choice(n, size=2, replace=False))
            nm = ["cz", "cphase"][int(rng.integers(2))]
            gates.append(cir.Gate(nm, (q0, q1), (float(rng.random() * 3),) if nm == "cphase" else ()))
    np.testing.assert_allclose(run_engine(psi, gates), reference(psi, gates), atol=5e-5)
