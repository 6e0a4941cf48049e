"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``bench.py``, ``chip_smoke.py`` and the
CLI runners): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing is set in code; otherwise the cache goes to a fixed directory
inside the checkout (listed in ``.gitignore``). The path is part of the
cache key, so a directory that moved between runs would never hit.

Tests do not call this: concurrent test workers sharing one on-disk cache
can corrupt its entries (see ``tests/conftest.py``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
