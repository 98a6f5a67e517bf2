"""Test harness configuration.

Tests run on CPU with 8 virtual devices so mesh/sharding semantics are
exercised without accelerator hardware, and with x64 enabled so complex128 parity
oracles (SURVEY.md §4: <=1e-12 amplitude parity) are meaningful.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_state(n: int, rng: np.random.Generator) -> np.ndarray:
    """Normalized random complex state on n qubits."""
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return (psi / np.linalg.norm(psi)).astype(np.complex128)
