"""Persistent compilation cache location (utils/compile_cache.py)."""

import os

import jax

from quantumcomputer.utils import compile_cache


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable() reports that directory
    and leaves JAX's own configuration alone."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_directory_in_checkout_without_env(monkeypatch):
    """Without the variable the cache is one fixed directory inside the
    checkout: no PID, temporary name or time in the path."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == compile_cache.CACHE_DIR == os.path.join(repo, ".xla_cache")
        assert os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable() == path  # idempotent, same path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()
