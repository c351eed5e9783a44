"""Profiling hooks (jax.profiler trace context)."""

from __future__ import annotations

import contextlib
from pathlib import Path


@contextlib.contextmanager
def profile_trace(log_dir, enabled: bool = True):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    if not enabled:
        yield
        return
    import jax

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(str(log_dir)):
        yield
