"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, chip_smoke.py, bench.py, the tools) calls
``enable_compile_cache`` before its first compile, so a cold run reuses
what earlier runs compiled.  ``JAX_COMPILATION_CACHE_DIR`` places the
cache from outside; otherwise it lives at ``<checkout>/.jax_cache`` — an
absolute path taken from the package's location (the path is part of
what the cache is found by, so it must not move with the cwd).
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_cache_dir() -> str:
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    when set (no other directory is set in code), else at
    ``<checkout>/.jax_cache``.  Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
