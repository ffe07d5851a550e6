"""Persistent XLA compilation cache setup.

Every entry point (app, bench, chip_smoke, driver hooks) calls ``enable()``
first, so a given (program, shape) pair compiles once per cache directory.
The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
it itself; nothing here overrides it), else a fixed path inside the
checkout (``.jax_cache/``, git-ignored): the path is part of the cache key,
so it must not move between runs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache lives in."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> bool:
    """Turn the persistent cache on when JAX's default backend is the GPU.
    CPU programs are not cached: CPU executables are machine-feature
    specific. Returns whether the cache is on."""
    import jax

    if jax.default_backend() != "gpu":
        return False
    if not os.environ.get(ENV):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return True
