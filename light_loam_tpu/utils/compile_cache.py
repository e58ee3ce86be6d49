"""Persistent XLA compile cache for the command-line entry points.

Called by the entry points (pipeline CLI, bench scripts, chip_smoke.py),
never at import.  The cache key includes the directory, so the path is
fixed: a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Keep compiled programs across processes; returns the directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it by itself and
    nothing is set here.  Otherwise the cache lives in the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
