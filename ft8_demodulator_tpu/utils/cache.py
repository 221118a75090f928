"""Persistent XLA compilation cache.

Every test session and benchmark run traces the same fixed-shape
programs; with a persistent cache the second run of an identical
program loads it instead of compiling again.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets no directory.  Otherwise the cache lives at the fixed
``.jax_cache/`` at the repo root (gitignored): the path is part of the
cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compile cache; returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took meaningful compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
