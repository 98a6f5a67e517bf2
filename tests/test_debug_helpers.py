"""Debug helpers (testing_and_debug.c equivalents, SURVEY §2 #21/#22)."""

import numpy as np

from quantumcomputer.utils.debug import (
    check_normalisation,
    display_state,
    state_to_kets,
)


def test_state_to_kets_order_and_format():
    psi = np.zeros(8, np.complex128)
    psi[1] = 1.0 / np.sqrt(2)
    psi[6] = 1j / np.sqrt(2)
    kets = state_to_kets(psi)
    # most-significant qubit first, ascending index order (reference print order)
    assert kets[0][0] == "|001>" and abs(kets[0][1] - 1 / np.sqrt(2)) < 1e-15
    assert kets[1][0] == "|110>" and abs(kets[1][1] - 1j / np.sqrt(2)) < 1e-15


def test_display_state_prints_nonzero_support(capsys):
    psi = np.zeros(4, np.complex128)
    psi[2] = -1.0
    text = display_state(psi)
    out = capsys.readouterr().out
    assert "|10>" in text and "|amp|=1.000000" in text
    assert text in out
    # atol filters numerical dust
    psi[0] = 1e-15
    assert "|00>" not in display_state(psi)


def test_check_normalisation_16dp(capsys):
    psi = np.array([0.6, 0.8j, 0, 0], np.complex128)
    total = check_normalisation(psi)
    out = capsys.readouterr().out
    assert abs(total - 1.0) < 1e-15
    # 16 decimal places like testing_and_debug.c:28-37
    assert "Total probability: 1.0000000000000000" in out
