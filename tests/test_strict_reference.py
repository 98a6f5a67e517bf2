"""Opt-in reference bug-compatibility mode (VERDICT r2 item 9 / missing #2).

The reference merely WARNS when 2^M < C and then runs the modular-multiply
with wrapped indices — scatter collisions, a non-unitary gate
(qc_shor.c:340-351 + the index wrap at :654).  The default engine refuses
that configuration; `StateVectorEngine(strict_reference=True)` reproduces
it exactly (matching the CPU oracle sim/reference.apply_c_amodc) so
TABLE-I-style side-by-side runs against the original binary work even in
its pathological configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcomputer.models.shor_circuit import shor_circuit
from quantumcomputer.sim import reference as ref
from quantumcomputer.sim.engine import Register, StateVectorEngine


def _amps(state) -> np.ndarray:
    return np.asarray(state[0], np.float64) + 1j * np.asarray(state[1], np.float64)


def test_default_engine_refuses_undersized_M():
    C, a, L, M = 15, 7, 3, 3  # 2^3 = 8 < 15
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    with pytest.raises(ValueError, match="not unitary"):
        eng.run(shor_circuit(C, a, L, M))


def test_strict_mode_matches_cpu_oracle_undersized_M():
    """Full pathological circuit: strict engine amplitudes == the CPU
    reference oracle's (collisions included) to 1e-12."""
    C, a, L, M = 15, 7, 3, 3
    circ = shor_circuit(C, a, L, M)
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, strict_reference=True)
    got = _amps(eng.run(circ))
    want = ref.shor_circuit(C, a, L, M)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_strict_op_reproduces_collisions():
    """Direct op-level collision check: C=21, M=4, A=2 maps f=8 -> 16,
    whose spill bit coincides with the (set) control bit — so f=8 and f=0
    both land on index 0 of the control=1 half.  The scatter ADDS them
    (probability not conserved), exactly as the CPU oracle does.

    (Full Shor circuits from the |0..01> reset rarely collide — the orbit
    of f=1 wraps onto f=0, which is unpopulated; that is WHY the reference
    'works' despite its warning.  The bug bites on general states.)"""
    from quantumcomputer.ops.gates import apply_c_amodc_strict

    C, A, M, L = 21, 2, 4, 1
    n = L + M
    c_q = M  # control is the single L qubit
    psi = np.zeros(1 << n, np.complex128)
    psi[(1 << c_q) | 8] = 0.6   # ctrl=1, f=8 -> A*f = 16 -> wraps onto index (1<<4)|0
    psi[(1 << c_q) | 0] = 0.8   # ctrl=1, f=0 -> 0     -> same target
    got = np.asarray(apply_c_amodc_strict(jnp.asarray(psi), C, A, c_q, M))
    want = ref.apply_c_amodc(psi, C, A, c_q, M)
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert abs(want[(1 << c_q) | 0] - (0.6 + 0.8)) < 1e-12  # amplitudes added
    assert abs(np.vdot(want, want).real - 1.0) > 0.5  # norm lost: non-unitary


def test_strict_mode_is_identical_when_M_is_sufficient():
    """With 2^M >= C the warn-and-wrap scatter IS the unitary permutation:
    strict and default engines agree exactly."""
    C, a, L, M = 21, 2, 4, 5
    circ = shor_circuit(C, a, L, M)
    e_strict = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, strict_reference=True)
    e_plain = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128)
    np.testing.assert_allclose(
        _amps(e_strict.run(circ)), _amps(e_plain.run(circ)), atol=1e-12
    )


def test_strict_mode_measurement_fall_through():
    """Measuring the non-normalized state keeps the reference's fall-through
    semantics (draw past the total lands on the last index family), and the
    whole find_period attempt still runs."""
    from quantumcomputer.algorithms.shor import find_period

    C, a, L, M = 15, 7, 3, 3
    eng = StateVectorEngine(Register(L=L, M=M), dtype=jnp.complex128, strict_reference=True)
    rec = find_period(eng, C, a, jax.random.PRNGKey(0), allow_template=True)
    assert 0 <= rec.measured_index < (1 << (L + M))


def test_strict_mode_guardrails():
    with pytest.raises(ValueError, match="strict_reference"):
        StateVectorEngine(Register(L=3, M=4), layout="m_high", strict_reference=True)
    from quantumcomputer.cli import main

    assert main(["-C", "15", "-L", "3", "-M", "3", "--strict-reference", "--devices", "2"]) == 2
    assert main(["-C", "15", "-L", "3", "-M", "3", "--strict-reference", "--dtype", "complex32"]) == 2


def test_strict_mode_cli_end_to_end(capsys):
    """The CLI path the reference user would run: warns about M, runs the
    wrapped gate, and (15, a=7, M=3) still factors — collisions spare the
    measured harmonics often enough at this size."""
    from quantumcomputer.cli import main

    rc = main(
        ["-C", "15", "-L", "3", "-M", "4", "-a", "7", "--seed", "0",
         "--dtype", "complex128", "--strict-reference"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "Factors of 15 found: (5, 3)." in out


def test_strict_flag_conflicts_with_provided_engine():
    """shors_algorithm(engine=..., strict_reference=True) must not silently
    ignore the flag (reviewer r3)."""
    from quantumcomputer.algorithms.shor import shors_algorithm

    eng = StateVectorEngine(Register(L=3, M=4), dtype=jnp.complex128)
    with pytest.raises(ValueError, match="strict_reference"):
        shors_algorithm(C=15, L=3, M=4, forced_trial_int=7, engine=eng, strict_reference=True)
    strict_eng = StateVectorEngine(
        Register(L=3, M=4), dtype=jnp.complex128, strict_reference=True
    )
    res = shors_algorithm(
        C=15, L=3, M=4, forced_trial_int=7, seed=0, engine=strict_eng, strict_reference=True
    )
    assert res.ok
