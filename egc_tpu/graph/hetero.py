"""Heterogeneous (typed) graph container for the rmag task.

Reference counterpart: per-relation ``SparseTensor`` dicts (reference
``experiments/rmag/configs.py:87-96``). Layout: per node type a padded
feature array + mask; per relation ("src__rel__dst" key) a padded COO edge
list whose senders index the source-type array and receivers the
destination-type array.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import jax.numpy as jnp

from egc_tpu.utils.pytree import pytree_dataclass


def rel_key(src: str, rel: str, dst: str) -> str:
    return f"{src}__{rel}__{dst}"


def split_rel_key(key: str) -> Tuple[str, str, str]:
    src, rel, dst = key.split("__")
    return src, rel, dst


@pytree_dataclass
class HeteroGraph:
    """Typed graph pytree: dicts keyed by node type / relation key."""

    nodes: Dict[str, Any]           # type -> [N_t, F] (features may be None
    #                                 for embedding-table types: empty array)
    node_mask: Dict[str, jnp.ndarray]
    senders: Dict[str, jnp.ndarray]    # rel_key -> [E_r] into src-type rows
    receivers: Dict[str, jnp.ndarray]  # rel_key -> [E_r] into dst-type rows
    edge_mask: Dict[str, jnp.ndarray]

    @property
    def node_types(self):
        return sorted(self.node_mask.keys())

    @property
    def relations(self):
        return sorted(self.senders.keys())

    def num_nodes(self, ntype: str) -> int:
        return self.node_mask[ntype].shape[0]


def hetero_from_numpy(nodes: Dict[str, np.ndarray],
                      edges: Dict[str, Tuple[np.ndarray, np.ndarray]],
                      *, node_multiple: int = 8,
                      edge_multiple: int = 128) -> HeteroGraph:
    """Pad per-type/per-relation arrays (nodes to ``node_multiple``, edges
    to ``edge_multiple``) with one padding row per type."""

    def round_up(x, m):
        return ((x + m - 1) // m) * m

    padded_nodes, masks = {}, {}
    n_pad = {}
    for t, x in nodes.items():
        n = x.shape[0]
        np_t = round_up(n + 1, node_multiple)
        n_pad[t] = np_t
        padded = np.zeros((np_t,) + x.shape[1:], x.dtype)
        padded[:n] = x
        padded_nodes[t] = padded
        m = np.zeros(np_t, bool)
        m[:n] = True
        masks[t] = m

    senders, receivers, emasks = {}, {}, {}
    for key, (s, r) in edges.items():
        src, _, dst = split_rel_key(key)
        e = len(s)
        ep = round_up(max(e, 1), edge_multiple)
        ss = np.full(ep, n_pad[src] - 1, np.int32)
        rr = np.full(ep, n_pad[dst] - 1, np.int32)
        ss[:e] = s
        rr[:e] = r
        em = np.zeros(ep, bool)
        em[:e] = True
        senders[key], receivers[key], emasks[key] = ss, rr, em

    return HeteroGraph(nodes=padded_nodes, node_mask=masks, senders=senders,
                       receivers=receivers, edge_mask=emasks)

