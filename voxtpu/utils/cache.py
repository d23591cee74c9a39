"""Persistent XLA compilation cache location.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here. Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``): a fixed path, since
the path is part of the cache key.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
