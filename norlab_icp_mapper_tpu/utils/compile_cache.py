"""Where the persistent XLA compile cache lives.

One rule for every entry point (``chip_smoke.py``, ``bench.py``, the
example driver, the baselines and the test suite): if
``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and nothing
else is set; otherwise the cache is ``.jax_cache/`` at the root of the
checkout (git-ignored).  A fixed path matters: the path is part of the
cache's key, so a directory that moves never hits.
"""
from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
