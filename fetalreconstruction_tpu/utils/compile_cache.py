"""Placement of JAX's persistent compilation cache.

Every entry point (the CLI mains, bench.py, chip_smoke.py, the tools and
the test configuration) calls configure_compile_cache() before its first
compile, so all of them share one cache and one rule:

- where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
  other directory is set;
- otherwise the cache lives at the fixed path
  <checkout>/.jax_compile_cache (listed in .gitignore).  The path is part
  of the cache key, so a fixed path is what lets a later process hit it.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_compile_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
