"""Static-shape graph containers.

Design notes
------------
XLA compiles one program per shape, so ragged graphs (the reference keeps
them as ragged ``edge_index`` tensors, reference ``experiments/zinc/configs.py:36-45``
DataLoader) become *padded, masked, fixed-shape* arrays here:

- ``nodes``:      ``[N, ...]`` node features, rows past the real nodes are padding.
- ``senders`` / ``receivers``: ``[E]`` int32 COO edge endpoints. Messages flow
  ``senders -> receivers`` (the reference aggregates ``x_j = x[edge_index[0]]``
  at ``edge_index[1]``; same convention here).
- ``node_mask`` / ``edge_mask``: validity masks. Padded edges additionally
  point at a padding node so garbage lands in masked rows.
- ``graph_ids``:  ``[N]`` graph membership for graph-level pooling (the
  reference's ``batch.batch`` vector). Padded nodes map to a padding graph.
- ``graph_mask``: ``[G]`` which graph slots are real.

A batch always reserves at least one padding node and one padding graph slot
(mirroring jraph's convention) so padded edges/nodes have somewhere safe to
point.

The same container serves batched mini-graphs (zinc/cifar/mol/code) and
single full graphs (arxiv/mag: one graph, ``graph_ids == 0``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from egc_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class Graph:
    """An immutable, static-shape (batched) graph. A JAX pytree.

    All fields are arrays (jnp on device, np on host). Feature arrays may be
    float or integer (categorical ids before embedding).
    """

    nodes: Any                      # [N, ...] node features
    senders: jnp.ndarray            # [E] int32
    receivers: jnp.ndarray          # [E] int32
    node_mask: jnp.ndarray          # [N] bool
    edge_mask: jnp.ndarray          # [E] bool
    graph_ids: jnp.ndarray          # [N] int32
    graph_mask: jnp.ndarray         # [G] bool
    edges: Optional[Any] = None     # [E, ...] edge features (optional)
    edge_weight: Optional[jnp.ndarray] = None  # [E] (optional) — when set,
    # convs treat it as the precomputed GCN symnorm edge weight (the
    # transductive "cached" path; also required for partitioned graphs where
    # local degree != global degree).
    self_weight: Optional[jnp.ndarray] = None  # [N] companion self-loop weight

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def replace_nodes(self, nodes) -> "Graph":
        return self.replace(nodes=nodes)

    @staticmethod
    def from_coo(
        nodes,
        senders,
        receivers,
        *,
        edges=None,
        edge_weight=None,
        num_nodes: Optional[int] = None,
    ) -> "Graph":
        """Build a single unpadded graph (full-graph training path)."""
        n = int(nodes.shape[0]) if num_nodes is None else num_nodes
        xp = jnp if isinstance(senders, jnp.ndarray) else np
        return Graph(
            nodes=nodes,
            senders=xp.asarray(senders, dtype=xp.int32),
            receivers=xp.asarray(receivers, dtype=xp.int32),
            node_mask=xp.ones((n,), dtype=bool),
            edge_mask=xp.ones((len(senders),), dtype=bool),
            graph_ids=xp.zeros((n,), dtype=xp.int32),
            graph_mask=xp.ones((1,), dtype=bool),
            edges=edges,
            edge_weight=edge_weight,
        )


def pad_graph(
    g: Graph,
    *,
    num_nodes: int,
    num_edges: int,
    num_graphs: Optional[int] = None,
) -> Graph:
    """Pad a host-side (numpy) Graph to fixed sizes.

    Padded edges point at the last (padding) node; padded nodes belong to the
    last (padding) graph. Requires ``num_nodes > real nodes`` when there are
    padded edges so they have a safe target.
    """
    n, e, gcount = g.num_nodes, g.num_edges, g.num_graphs
    num_graphs = num_graphs if num_graphs is not None else gcount
    if num_nodes < n or num_edges < e or num_graphs < gcount:
        raise ValueError(
            f"pad_graph target sizes ({num_nodes},{num_edges},{num_graphs}) "
            f"smaller than actual ({n},{e},{gcount})"
        )
    dn, de, dg = num_nodes - n, num_edges - e, num_graphs - gcount
    if de > 0 and dn == 0:
        raise ValueError("padding edges require at least one padding node")

    def pad_rows(x, count):
        if x is None or count == 0:
            return x
        pad_width = [(0, count)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), pad_width)

    pad_node_idx = num_nodes - 1
    senders = np.concatenate(
        [np.asarray(g.senders), np.full((de,), pad_node_idx, dtype=np.int32)]
    ).astype(np.int32)
    receivers = np.concatenate(
        [np.asarray(g.receivers), np.full((de,), pad_node_idx, dtype=np.int32)]
    ).astype(np.int32)
    graph_ids = np.concatenate(
        [np.asarray(g.graph_ids), np.full((dn,), max(num_graphs - 1, 0), dtype=np.int32)]
    ).astype(np.int32)

    return Graph(
        nodes=pad_rows(g.nodes, dn),
        senders=senders,
        receivers=receivers,
        node_mask=np.concatenate([np.asarray(g.node_mask), np.zeros((dn,), bool)]),
        edge_mask=np.concatenate([np.asarray(g.edge_mask), np.zeros((de,), bool)]),
        graph_ids=graph_ids,
        graph_mask=np.concatenate([np.asarray(g.graph_mask), np.zeros((dg,), bool)]),
        edges=pad_rows(g.edges, de),
        edge_weight=pad_rows(g.edge_weight, de),
        self_weight=pad_rows(g.self_weight, dn),
    )


def batch_np(
    graphs: Sequence[dict],
    *,
    num_nodes: int,
    num_edges: int,
    num_graphs: int,
):
    """Concatenate host-side graphs into one padded batch.

    Each element of ``graphs`` is a dict with keys ``nodes``, ``senders``,
    ``receivers`` and optionally ``edges``, ``y``. Returns ``(Graph, ys)``
    where ``ys`` is ``[num_graphs, ...]`` zero-padded graph labels (or None).

    ``num_graphs`` must be > len(graphs) (one padding graph slot) and
    ``num_nodes`` > total nodes (one padding node slot) whenever padding
    edges are needed.
    """
    if len(graphs) >= num_graphs:
        raise ValueError("need at least one padding graph slot")
    nodes_list, senders_list, receivers_list, edges_list, gid_list, ys = (
        [], [], [], [], [], []
    )
    offset = 0
    for i, gd in enumerate(graphs):
        nd = np.asarray(gd["nodes"])
        nodes_list.append(nd)
        senders_list.append(np.asarray(gd["senders"], dtype=np.int32) + offset)
        receivers_list.append(np.asarray(gd["receivers"], dtype=np.int32) + offset)
        if gd.get("edges") is not None:
            edges_list.append(np.asarray(gd["edges"]))
        gid_list.append(np.full((nd.shape[0],), i, dtype=np.int32))
        if gd.get("y") is not None:
            ys.append(np.asarray(gd["y"]))
        offset += nd.shape[0]

    g = Graph(
        nodes=np.concatenate(nodes_list, axis=0),
        senders=np.concatenate(senders_list),
        receivers=np.concatenate(receivers_list),
        node_mask=np.ones((offset,), bool),
        edge_mask=np.ones((sum(len(s) for s in senders_list),), bool),
        graph_ids=np.concatenate(gid_list),
        graph_mask=np.ones((len(graphs),), bool),
        edges=np.concatenate(edges_list, axis=0) if edges_list else None,
    )
    g = pad_graph(g, num_nodes=num_nodes, num_edges=num_edges, num_graphs=num_graphs)

    y_out = None
    if ys:
        y_arr = np.stack(ys, axis=0)
        pad_width = [(0, num_graphs - y_arr.shape[0])] + [(0, 0)] * (y_arr.ndim - 1)
        y_out = np.pad(y_arr, pad_width)
    return g, y_out
