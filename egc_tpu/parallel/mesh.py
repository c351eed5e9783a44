"""Device mesh construction.

Single entry point for all multi-device topology: batched tasks shard over
the ``data`` axis, full-graph tasks over the ``graph`` axis. Collectives
(psum for gradients / sync-BN, all_to_all for halo exchange) are JAX
collectives over these axes, which XLA hands to NCCL on GPUs (NVLink within
a host). Multi-host runs call ``jax.distributed.initialize`` before
building the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def device_count() -> int:
    return jax.device_count()


def make_mesh(axes: Dict[str, int], *, devices: Optional[Sequence] = None
              ) -> Mesh:
    """Build a named mesh, e.g. make_mesh({"data": 4, "graph": 2}).

    Axis sizes must multiply to the number of participating devices
    (default: the first that many of ``jax.devices()``).
    """
    shape = tuple(axes.values())
    total = int(np.prod(shape))
    devices = list(devices) if devices is not None else \
        jax.devices()[:total]
    if total != len(devices):
        raise ValueError(
            f"mesh axes {axes} need {total} devices, have {len(devices)}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axes.keys()))
