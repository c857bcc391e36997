"""Persistent XLA compilation cache for generation/training entry points.

One-time JIT compiles dominate the first scene of every (mode,
n_objects) shape class.  JAX can persist compiled executables across
processes, so repeat runs — the production case for a dataset generator
that is resumable per scene — skip straight to steady state.

Rules, in order:
  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this
    module sets nothing;
  * ``PEGASUS_TPU_COMPILE_CACHE=0``: no persistent cache;
  * otherwise the cache lives at one fixed path inside the checkout,
    ``<repo>/.jax_cache`` (git-ignored).  The path is part of the cache's
    key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")
_enabled = False


def enable_compilation_cache() -> str | None:
    """Point JAX's persistent compilation cache at its directory.

    Idempotent; safe to call from every entry point.  Returns the cache
    directory this call set, or None when it set none (see the module
    docstring, or an unwritable directory).  Only compiles slower than
    2 s are persisted — steady-state dispatch is never IO-taxed.
    """
    global _enabled
    if _enabled:
        return None
    _enabled = True  # one attempt per process, even on failure
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if os.environ.get("PEGASUS_TPU_COMPILE_CACHE") == "0":
        return None
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
    except OSError:
        return None  # cache is an optimization, never a failure mode
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return DEFAULT_DIR
