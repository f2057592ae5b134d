"""Persistent XLA compilation cache for every intentbev entry point.

Enabled by every CLI/bench entry (train, evaluate, bench.py,
chip_smoke.py, tools/bench_train.py, __graft_entry__). The directory is
``JAX_COMPILATION_CACHE_DIR`` when that is set — JAX reads it itself and
nothing else is configured in code — and otherwise the fixed
``<checkout>/.jax_cache`` (listed in .gitignore). Cache keys include
platform, XLA flags and program fingerprint, so one directory serves CPU
and GPU safely.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_ENABLED = False


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compilation_cache() -> None:
    """Idempotently switch on JAX's persistent compilation cache."""
    global _ENABLED
    if _ENABLED:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    # cache everything that takes >2 s to compile, at any artifact size
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _ENABLED = True
