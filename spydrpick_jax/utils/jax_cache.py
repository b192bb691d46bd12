"""Where JAX keeps its persistent compilation cache.

One policy for every entry point (CLI, bench.py, chip_smoke.py, the
tests): an explicit directory wins ('none' leaves the cache alone);
otherwise ``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself, so
nothing is set in code; otherwise one fixed directory inside the
checkout, ``<checkout>/.jax_cache`` (listed in .gitignore).  A fixed
path matters: the path is part of the cache key, so a directory that
moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def resolve_cache_dir(override: str | None = None,
                      environ=os.environ) -> str | None:
    """The compile-cache directory a run uses (None: cache left alone)."""
    if override is not None:
        return None if override.lower() == "none" else os.path.expanduser(override)
    return environ.get(ENV_VAR) or CHECKOUT_CACHE_DIR


def configure_compile_cache(override: str | None = None,
                            min_compile_secs: float = 1.0) -> str | None:
    """Apply :func:`resolve_cache_dir`; returns the directory in use."""
    import jax

    path = resolve_cache_dir(override)
    if path is None:
        return None
    if override is not None or not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
