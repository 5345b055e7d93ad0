"""Persistent JAX compile cache: one place decides where it lives."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> None:
    """Keep compiled programs across processes. Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    else is set; otherwise the cache lives in ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(CHECKOUT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
