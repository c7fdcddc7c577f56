"""Persistent XLA compilation cache for the entry points (CLI, bench.py,
chip_smoke.py).

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise compiled programs go to one fixed directory at the
root of the checkout (listed in .gitignore): the cache key includes the
path, so a directory that moved between runs would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent cache at the directory above; returns it."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = str(DEFAULT_DIR)
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
