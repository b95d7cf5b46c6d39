"""Where XLA's persistent compile cache lives.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and this
module sets nothing. Otherwise the cache goes to one fixed directory inside
the checkout (`<checkout>/.jax_cache`, git-ignored). The path is part of the
cache key, so it is never built from a temporary name, a pid or the time.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None) -> str:
    """The cache directory for this environment (no side effects)."""
    env = os.environ if environ is None else environ
    return env.get(ENV_VAR) or str(CHECKOUT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX at `cache_dir()`; call before the first compilation."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
