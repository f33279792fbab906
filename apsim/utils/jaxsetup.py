"""Process-wide JAX setup: the persistent compilation cache.

The engines compile one program per shape bucket; the persistent cache lets
every later process reuse them.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX keeps its cache there and this module sets no other directory.
Otherwise the cache lives at a fixed ``<checkout>/.jax_cache`` — a fixed
path, because the path is part of the cache key.  Safe to call multiple
times; a process that disabled the cache (the CPU test suite) keeps it off.
"""

from __future__ import annotations

import os

_DONE = False

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    env = os.environ.get(ENV)
    if env:
        return env
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(checkout, ".jax_cache")


def setup_jax() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return
    if not os.environ.get(ENV):
        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
