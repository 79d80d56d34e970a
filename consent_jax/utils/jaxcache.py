"""Persistent XLA compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and
this module sets no other directory.  Otherwise the cache lives at the
fixed `<checkout>/.jax_cache` (the path is part of the cache key, so
it must not move between runs).  Call enable() before building any
jitted computation.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
