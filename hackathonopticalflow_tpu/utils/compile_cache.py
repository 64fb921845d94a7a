"""Persistent XLA compilation cache for the entry points.

Every entry point (the apps' `main`, bench.py, chip_smoke.py) calls
`enable_compile_cache()` before it compiles anything. Where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
changed. Otherwise the cache goes to `<checkout>/.jax_cache` — a fixed
path, because the directory is part of the cache key.
"""

from __future__ import annotations

import os

import jax

#: <checkout>/.jax_cache, derived from this file's place in the package
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
