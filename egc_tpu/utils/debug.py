"""Determinism + numerical guards.

XLA programs are data-race-free by construction (SURVEY §5: no sanitizer
needed); what remains configurable:

- ``enable_determinism()``: bit-reproducible reductions/scatters across runs
  on the same topology (the reference explicitly disclaims GPU determinism,
  hyperparameters.md:3; XLA can give it at some speed cost).
- ``check_finite``: NaN/Inf guard for metric dicts / pytrees; raises with
  the offending path (the role of torch's anomaly detection).
- ``seed_all``: host-side RNG seeding (reference experiments/utils.py:12-17;
  device RNG is explicit via jax.random keys).
"""

from __future__ import annotations

import os
import random
from typing import Any

import numpy as np


DETERMINISM_FLAG = "--xla_gpu_deterministic_ops=true"


def enable_determinism():
    """Force deterministic XLA ops: on the GPU, scatter-adds (the segment
    sums) run without atomics so results repeat bit for bit. Call before
    the JAX backend starts: XLA reads ``XLA_FLAGS`` once, at start-up."""
    flags = os.environ.get("XLA_FLAGS", "")
    if DETERMINISM_FLAG not in flags:
        os.environ["XLA_FLAGS"] = (flags + " " + DETERMINISM_FLAG).strip()
    import jax

    try:
        jax.config.update("jax_threefry_partitionable", True)
    except AttributeError:  # pragma: no cover
        pass


def seed_all(seed: int):
    """Seed python/numpy host RNGs (device RNG is per-key, explicit)."""
    random.seed(seed)
    np.random.seed(seed)


def check_finite(tree: Any, *, name: str = "value") -> Any:
    """Raise FloatingPointError if any leaf contains NaN/Inf; returns tree."""
    import jax
    import numpy as _np

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = _np.asarray(leaf)
        if arr.dtype.kind == "f" and not _np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}")
    return tree
