"""Persistent XLA compilation cache at a fixed location.

Scripts call :func:`enable_compile_cache` once, before their first compile.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and nothing else is configured; otherwise the cache lives in ``.jax_cache``
at the root of this checkout (a fixed path, so later runs of the same
checkout find what earlier ones compiled).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
