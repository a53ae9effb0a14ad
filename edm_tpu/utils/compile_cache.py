"""Persistent XLA compilation cache, kept in one place.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives in ``.jax_cache/`` at the root of the checkout (gitignored).  The
path is part of the cache key, so a fixed location is what lets one run
reuse another's compiled programs.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the path.  Call before the first compile."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
