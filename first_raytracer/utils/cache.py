"""Persistent compilation cache: where compiled programs are kept.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and nothing here overrides it.  Otherwise every entry point keeps its cache
at one fixed path inside the checkout (``.jax_cache/``, listed in
.gitignore): the path is part of the cache key, so a directory that moved
between runs would never hit.
"""
from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_persistent_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(environ=os.environ) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or the fixed
    ``.jax_cache`` directory at the root of the checkout."""
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_persistent_cache() -> None:
    """Point JAX's persistent cache at ``cache_dir()`` (idempotent)."""
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", cache_dir())
