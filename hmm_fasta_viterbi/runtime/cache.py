"""Persistent XLA compile cache shared by every entry point (the CLI,
bench.py, chip_smoke.py)."""

from __future__ import annotations

import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Keep compiled programs across processes. ``JAX_COMPILATION_CACHE_DIR``
    wins when set (JAX reads it itself, and nothing else is set here);
    otherwise the cache is ``<repo>/.jax_cache``. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(REPO / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
