"""Host-side batched graph loader with static padding budgets.

Replaces the reference's PyG ``DataLoader(batch_size=...)`` (reference
``experiments/zinc/configs.py:36-45``). Every batch is padded to
the SAME (num_nodes, num_edges, num_graphs) budget so the train step compiles
exactly once. The final short batch of an epoch is padded with empty graph
slots rather than dropped (step-count parity with the reference's loader).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from egc_tpu.graph.structure import Graph, batch_np


def padding_budget(
    graphs: Sequence[dict],
    batch_size: int,
    *,
    node_multiple: int = 8,
    edge_multiple: int = 128,
) -> Tuple[int, int, int]:
    """Static (nodes, edges, graphs) budget covering any batch of the dataset.

    Worst-case-exact for heavy-tailed size distributions: any batch of
    ``batch_size`` graphs is bounded by the ``batch_size`` LARGEST graphs
    (much tighter than batch_size * max for e.g. code2 ASTs), plus pad
    slots, rounded up to the given multiples.
    """
    node_counts = sorted(int(np.asarray(g["nodes"]).shape[0])
                         for g in graphs)
    edge_counts = sorted(len(g["senders"]) for g in graphs)

    def round_up(x, m):
        return ((x + m - 1) // m) * m

    num_nodes = round_up(sum(node_counts[-batch_size:]) + 1, node_multiple)
    num_edges = round_up(max(sum(edge_counts[-batch_size:]), 1),
                         edge_multiple)
    return num_nodes, num_edges, batch_size + 1


class GraphLoader:
    """Iterates fixed-shape padded batches over a list of graph dicts.

    ``prefetch=N`` builds N batches ahead on a thread pool (host-side
    numpy only), overlapping with the device step.
    """

    def __init__(
        self,
        graphs: List[dict],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        budget: Optional[Tuple[int, int, int]] = None,
        drop_last: bool = False,
        cache_limit_bytes: int = 4 << 30,
        prefetch: int = 0,
    ):
        self.graphs = graphs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.budget = budget or padding_budget(graphs, batch_size)
        self.prefetch = prefetch
        self.drop_last = drop_last
        # eval loaders iterate the identical batches every epoch: build once
        # — but only while under cache_limit_bytes (real code2's 452k padded
        # ASTs would be tens of GB; beyond the limit batches are re-built
        # per epoch instead of held in host RAM)
        self.cache_limit_bytes = cache_limit_bytes
        self._cache = None if shuffle else []
        self._cache_bytes = 0
        self._cache_complete = False

    def __len__(self) -> int:
        n = len(self.graphs)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _build(self, idx):
        bn, be, bg = self.budget
        batch = [self.graphs[i] for i in idx]
        g, y = batch_np(batch, num_nodes=bn, num_edges=be, num_graphs=bg)
        return (g, y)

    def _batches(self, order):
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self) -> Iterator[Tuple[Graph, np.ndarray]]:
        if self._cache_complete:
            yield from self._cache
            return
        if self._cache is not None:
            self._cache = []        # restart partial cache (early break)
            self._cache_bytes = 0
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self._rng.shuffle(order)
        from egc_tpu.data.prefetch import prefetched
        for item in prefetched(self._build,
                               ((idx,) for idx in self._batches(order)),
                               self.prefetch):
            yield self._maybe_cache(item)
        if self._cache is not None:
            self._cache_complete = True

    def _maybe_cache(self, item):
        if self._cache is not None:
            import jax
            self._cache_bytes += sum(
                a.nbytes for a in jax.tree.leaves(item)
                if hasattr(a, "nbytes"))
            if self._cache_bytes > self.cache_limit_bytes:
                self._cache = None          # too big: rebuild per epoch
            else:
                self._cache.append(item)
        return item
