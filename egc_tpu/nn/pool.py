"""Graph-level readout pools (masked segment reductions over graph ids).

Equivalents of PyG's ``global_{mean,add,max}_pool`` (used by every
graph-level model in the reference, e.g. ``experiments/zinc/models.py:46-53``),
with explicit padding masks.
"""

from __future__ import annotations

from egc_tpu.ops import segment_sum, segment_mean, segment_max


def global_add_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_sum(x, graph_ids, num_graphs, mask=node_mask)


def global_mean_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_mean(x, graph_ids, num_graphs, mask=node_mask)


def global_max_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_max(x, graph_ids, num_graphs, mask=node_mask)


_POOLS = {
    "mean": global_mean_pool,
    "sum": global_add_pool,
    "add": global_add_pool,
    "max": global_max_pool,
}


def get_pool(name: str):
    if name not in _POOLS:
        raise ValueError(f"unknown readout {name!r}; supported {sorted(_POOLS)}")
    return _POOLS[name]
