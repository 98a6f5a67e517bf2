"""Installed-layout packaging contracts (pyproject.toml / setup.py).

The native classical layer is a plain ctypes shared library: wheels carry
it as quantumcomputer/libqc_classical.so (built by setup.py's
BuildSharedLib), the dev checkout keeps native/libqc_classical.so.  The
loader must prefer a package-local library and fall back to the dev path.
"""

import os

from quantumcomputer.algorithms import _native


def test_find_lib_prefers_package_local(tmp_path, monkeypatch):
    fake = tmp_path / "libqc_classical.cpython-312-x86_64-linux-gnu.so"
    fake.write_bytes(b"")
    monkeypatch.setattr(_native, "_PKG_DIR", str(tmp_path))
    assert _native._find_lib() == str(fake)


def test_find_lib_dev_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "_PKG_DIR", str(tmp_path))  # no local lib
    dev = tmp_path / "native" / "libqc_classical.so"
    dev.parent.mkdir()
    dev.write_bytes(b"")
    monkeypatch.setattr(_native, "_LIB_PATH", str(dev))
    assert _native._find_lib() == str(dev)


def test_find_lib_none_when_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "_PKG_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_LIB_PATH", str(tmp_path / "nope.so"))
    assert _native._find_lib() is None


def test_pyproject_declares_entry_point():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "pyproject.toml")).read()
    assert 'qc-sim = "quantumcomputer.cli:main"' in text
    assert 'libqc_classical*.so' in text  # wheel ships the ctypes library


def test_version_single_source():
    import quantumcomputer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "pyproject.toml")).read()
    assert f'version = "{quantumcomputer.__version__}"' in text


def test_top_level_exports():
    import quantumcomputer as q

    for name in (
        "Register", "StateVectorEngine", "ShardedStateVectorEngine",
        "DDStateVectorEngine", "build_mesh", "shor_circuit",
        "shors_algorithm", "find_period", "read_omega", "Outcome",
        "ShorResult", "grover_search", "grover_circuit", "estimate_phase",
        "amplitude_estimate", "run_semiclassical", "run_quantum_volume",
        "bernstein_vazirani", "deutsch_jozsa", "simon_search", "circuit",
    ):
        assert hasattr(q, name), name
