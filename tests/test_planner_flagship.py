"""Execution-plan guard for the FLAGSHIP circuit (C=8191, M=13, m_high).

The engine executes one pass per entry of engine.planned_circuit: at
the sizes the flagship is measured (n >= 28) every gate is its own pass
(the composed-ladder index tensor is not worth its memory there); small
states compose the oracle run into ladders.  Drift in this plan changes
the wall-clock — this test pins it.
"""

from quantumcomputer.models.shor_circuit import shor_circuit_mhigh
from quantumcomputer.sim.engine import LADDER_FUSE_MAX_DIM, MAX_LADDER_RUN, planned_circuit

C, A, M = 8191, 3, 13


def _plan(n: int):
    L = n - M
    return planned_circuit(shor_circuit_mhigh(C, A, L, M), 0, 1 << n)


def test_flagship_n28_segmentation():
    """n=28: 15 H butterflies + 15 oracle singles + 15 iQFT stages, one
    pass each."""
    names = [g.name for g in _plan(28)]
    assert len(names) == 45
    assert names.count("camodc_high") == 15
    assert names.count("iqft_stage") == 15
    assert "camodc_ladder_high" not in names


def test_flagship_small_state_composes_ladders():
    """At the ladder-fusion bound the 11-gate oracle run composes into
    ladders of at most MAX_LADDER_RUN gates."""
    n = LADDER_FUSE_MAX_DIM.bit_length() - 1
    plan = _plan(n)
    ladders = [g for g in plan if g.name == "camodc_ladder_high"]
    assert ladders and all(len(g.qubits) <= MAX_LADDER_RUN for g in ladders)
    assert sum(len(g.qubits) for g in ladders) == n - M
    assert not any(g.name == "camodc_high" for g in plan)
