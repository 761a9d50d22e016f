"""Persistent XLA compile cache shared by the entry points."""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Keep compiled programs on disk between processes and return the
    directory.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and nothing is set here; otherwise the cache is the repository's
    .jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
