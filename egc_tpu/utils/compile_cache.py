"""JAX's persistent compilation cache, at one fixed place.

``enable_compile_cache()`` is called by the entry points (``main.py``,
``bench.py``, ``chip_smoke.py``) before their first compilation. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory and
nothing else is set here. Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout: a fixed path, because the path is part of what a
later process must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
