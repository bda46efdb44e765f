"""Where the program keeps what it caches between runs.

Two caches live under one fixed directory inside the checkout
(``.cache/`` at the repository root, listed in ``.gitignore``): JAX's
persistent compilation cache and the calibration-derived tables
(rectification maps, X-maps).  A fixed path matters: the compilation
cache is keyed by what is compiled, and a directory that moves between
runs never hits.
"""

from __future__ import annotations

import os

__all__ = ["CACHE_ROOT", "cache_dir", "enable_compile_cache"]

#: <checkout>/.cache
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
)


def cache_dir(name: str) -> str:
    """A named subdirectory of the checkout's cache root."""
    return os.path.join(CACHE_ROOT, name)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to
    ``<checkout>/.cache/jax``.  Every entry point calls this before its
    first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = cache_dir("jax")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
