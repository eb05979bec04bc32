"""Persistent XLA compilation cache.

Every re-jit after the first (capacity growth, process restarts,
resume, the next process of a benchmark run) becomes a disk hit
instead of a recompile.  Enabled by the tracker and the benchmark
scripts where :func:`orbitanalysis_tpu.policy.compile_cache_enabled`
says so.

Placement: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here sets a directory.  Otherwise the cache lives at
one fixed path inside the checkout (:data:`DEFAULT_DIR`, listed in
``.gitignore``): the path is part of what makes a later process find
the entries, so it is never temporary, per-process or time-stamped.
"""

from __future__ import annotations

import os

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)
_enabled = False


def cache_dir() -> str:
    """Where the persistent cache lives (env var, else the fixed
    in-checkout path)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str | None:
    """Idempotently turn on JAX's persistent compilation cache where
    the policy allows it.  Returns the cache directory, or ``None``
    when the cache stays off (CPU)."""
    global _enabled
    import jax

    from orbitanalysis_tpu.policy import compile_cache_enabled

    if not compile_cache_enabled():
        return None
    path = cache_dir()
    if _enabled:
        return path
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_enable_compilation_cache", True)
    # small steps are cacheable too — the tracker re-jits on growth
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
    return path
