"""quantumcomputer: a JAX state-vector quantum simulator.

A JAX/XLA rebuild of the capabilities of the reference GSL-based
Shor's-algorithm simulator (adamalderton/QuantumComputer): a 2^n complex
amplitude vector lives in device memory (sharded over a device mesh at
scale); gates apply as strided-axis contractions, fused diagonals, and
permutation gathers — never as materialized 2^N x 2^N matrices.
"""

from quantumcomputer.algorithms.amplitude_estimation import amplitude_estimate  # noqa: F401
from quantumcomputer.algorithms.grover import grover_circuit, grover_search  # noqa: F401
from quantumcomputer.algorithms.oracle_algorithms import (  # noqa: F401
    bernstein_vazirani,
    deutsch_jozsa,
)
from quantumcomputer.algorithms.qpe import estimate_phase  # noqa: F401
from quantumcomputer.algorithms.simon import simon_search  # noqa: F401
from quantumcomputer.algorithms.quantum_volume import run_quantum_volume  # noqa: F401
from quantumcomputer.algorithms.semiclassical import run_semiclassical  # noqa: F401
from quantumcomputer.algorithms.variational import (  # noqa: F401
    HardwareEfficientAnsatz,
    expectation,
    expectation_on_engine,
    pauli_term,
    qaoa_maxcut,
    vqe,
)
from quantumcomputer.algorithms.shor import (  # noqa: F401
    Outcome,
    ShorResult,
    find_period,
    read_omega,
    shors_algorithm,
)
from quantumcomputer.models import circuit  # noqa: F401
from quantumcomputer.models.shor_circuit import shor_circuit, shor_circuit_reference  # noqa: F401
from quantumcomputer.parallel.mesh import build_mesh  # noqa: F401
from quantumcomputer.parallel.sharded import ShardedStateVectorEngine  # noqa: F401
from quantumcomputer.sim.dd_engine import DDStateVectorEngine  # noqa: F401
from quantumcomputer.sim.engine import Register, StateVectorEngine  # noqa: F401

__version__ = "0.3.0"
