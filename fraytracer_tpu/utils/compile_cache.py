"""Persistent XLA compile cache for the repository's scripts.

The library itself never sets a cache.  Scripts (``bench.py``,
``chip_smoke.py``, ``tools/``) call :func:`enable_compile_cache`: where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
set in code; otherwise the cache lives at one fixed path inside the
checkout (``.jax_cache/``, listed in ``.gitignore``) so that repeated runs
find what earlier ones compiled.
"""
from __future__ import annotations

import os
from typing import Mapping

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """The cache directory scripts use: ``$JAX_COMPILATION_CACHE_DIR`` if
    set, else the checkout's ``.jax_cache/``."""
    return environ.get(ENV) or REPO_CACHE


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and
    return it (only sets the path when the environment does not)."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
