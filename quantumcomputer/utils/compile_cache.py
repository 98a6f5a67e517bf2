"""Persistent XLA compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here changes.  Otherwise the cache lives in one fixed directory inside the
checkout (CACHE_DIR, listed in .gitignore): the path is part of the
cache's key, so it never depends on a process, a temporary name or the
time.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".xla_cache",
)


def enable() -> str:
    """Turn the persistent cache on (idempotent); returns its directory."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CACHE_DIR
