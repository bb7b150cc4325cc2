"""JAX persistent compilation cache: one directory for every entry point.

A cold process would otherwise recompile the walk and count programs on
every invocation. `JAX_COMPILATION_CACHE_DIR` wins when it is set;
otherwise the cache lives at one fixed path inside the checkout
(`<repo>/.jax_cache`, git-ignored). The path is part of what keeps the
cache warm, so it never depends on a temp name, a PID or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the env var when set, else DEFAULT_DIR."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent cache at cache_dir() and cache every
    program, however small or quick to compile. Returns the directory."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
