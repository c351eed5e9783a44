"""Neighbor-sampled mini-batch loader for MAG-scale graphs.

New scope vs the reference (which trains ogbn-mag full-graph on one GPU,
SURVEY §2.4 "sampling parallelism"): GraphSAGE-style layered neighbor
sampling so graphs that exceed chip memory train on padded, static-shape
subgraph batches. Each batch:

- seeds: ``batch_size`` target nodes (loss is computed on these only);
- per hop k, up to ``fanouts[k]`` in-neighbors of the current frontier are
  sampled; sampled edges point INTO the frontier (message flow matches
  full-graph training);
- the subgraph is padded to the static worst-case budget so the train step
  compiles once.

Shard seeds across hosts/devices for distributed sampling-parallel training
(each device consumes its own seed stream; gradients psum — the DP path).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

from egc_tpu.graph.structure import Graph, pad_graph


class NeighborSampler:
    """Layered in-neighbor sampler over a static COO graph."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int, fanouts: Sequence[int] = (10, 5),
                 seed: int = 0):
        self.num_nodes = num_nodes
        self.fanouts = tuple(fanouts)
        order = np.argsort(receivers, kind="stable")
        self._in_senders = senders[order].astype(np.int64)
        self._rowptr = np.searchsorted(receivers[order],
                                       np.arange(num_nodes + 1))
        self._rng = np.random.default_rng(seed)

    def budgets(self, batch_size: int) -> Tuple[int, int]:
        """Worst-case (nodes, edges) for a batch (before padding multiples)."""
        nodes, frontier, edges = batch_size, batch_size, 0
        for f in self.fanouts:
            edges += frontier * f
            frontier = frontier * f
            nodes += frontier
        return nodes + 1, edges

    def sample(self, seeds: np.ndarray, rng=None):
        """Returns (global_node_ids, senders_local, receivers_local,
        seed_count) — seeds occupy local slots [0, len(seeds)).

        Fully vectorized (numpy frontier sweeps — the per-node python
        loop was the host bottleneck at mag scale): per hop, every
        candidate in-edge of the frontier gets a random key and each
        receiver keeps its ``fanout`` smallest keys (exact without-
        replacement sampling). ``rng``: optional per-call generator so
        prefetch threads don't race the shared stream."""
        from egc_tpu.parallel.partition import _segmented_arange

        rng = self._rng if rng is None else rng
        seeds = np.asarray(seeds, np.int64)
        loc = np.full(self.num_nodes, -1, np.int32)   # per-call scratch
        loc[seeds] = np.arange(len(seeds))
        node_ids = seeds.copy()
        s_parts, r_parts = [], []
        frontier = seeds
        for fanout in self.fanouts:
            if not len(frontier):
                break
            deg = self._rowptr[frontier + 1] - self._rowptr[frontier]
            cand = _segmented_arange(self._rowptr[frontier], deg)
            if not len(cand):    # frontier is all zero-degree: done
                break
            recv = np.repeat(frontier, deg)
            keys = rng.random(len(cand))
            order = np.lexsort((keys, recv))
            rs = recv[order]
            change = np.r_[True, rs[1:] != rs[:-1]]
            seg = np.maximum.accumulate(
                np.where(change, np.arange(len(rs)), 0))
            keep = (np.arange(len(rs)) - seg) < fanout
            sel = cand[order][keep]
            rsel = rs[keep]
            u = self._in_senders[sel]
            new_nodes = np.unique(u[loc[u] < 0])
            loc[new_nodes] = len(node_ids) + np.arange(len(new_nodes))
            node_ids = np.concatenate([node_ids, new_nodes])
            s_parts.append(loc[u].astype(np.int32))
            r_parts.append(loc[rsel].astype(np.int32))
            frontier = new_nodes
        s_loc = (np.concatenate(s_parts) if s_parts
                 else np.zeros(0, np.int32))
        r_loc = (np.concatenate(r_parts) if r_parts
                 else np.zeros(0, np.int32))
        return node_ids, s_loc, r_loc, len(seeds)


class SampledNodeLoader:
    """Yields padded subgraph batches (Graph, y, seed_mask) for node
    classification over seed splits.

    ``prefetch=N``: batches (sampling + padding — all host-side numpy)
    are built N ahead on a thread pool, overlapping with the device
    step; per-batch rng streams are derived from the epoch
    order so results are identical to the synchronous loader.
    ``gather_on_device=True``: graphs carry ZERO-WIDTH node features and
    each item appends the padded global-id array — the training step
    gathers rows from the device-resident full feature matrix
    (``x_full[gids]``), so the per-batch host->device transfer is the gid
    list (KBs) instead of the gathered features (tens of MBs).
    """

    def __init__(self, sampler: NeighborSampler, x: np.ndarray,
                 y: np.ndarray, seed_ids: np.ndarray, batch_size: int,
                 *, shuffle: bool = True, rng_seed: int = 0,
                 prefetch: int = 0,
                 gather_on_device: bool = False):
        self.sampler = sampler
        self.x, self.y = x, y
        self.gather_on_device = gather_on_device
        self.seed_ids = np.asarray(seed_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng_seed = rng_seed
        self._rng = np.random.default_rng(rng_seed)
        self.prefetch = prefetch
        n_budget, e_budget = sampler.budgets(batch_size)
        self.node_budget = ((n_budget + 7) // 8) * 8
        self.edge_budget = ((e_budget + 127) // 128) * 128
        self._batch_counter = 0

    def __len__(self):
        return (len(self.seed_ids) + self.batch_size - 1) // self.batch_size

    def _build(self, seeds: np.ndarray, batch_id: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.rng_seed, batch_id]))
        gids, s, r, n_seed = self.sampler.sample(seeds, rng=rng)
        if self.gather_on_device:
            nodes = np.zeros((len(gids), 0), np.float32)
        else:
            nodes = self.x[gids]
        g = Graph.from_coo(nodes, s, r)
        g = pad_graph(g, num_nodes=self.node_budget,
                      num_edges=self.edge_budget)
        y = np.zeros(self.node_budget, self.y.dtype)
        y[:len(gids)] = self.y[gids]
        seed_mask = np.zeros(self.node_budget, bool)
        seed_mask[:n_seed] = True
        if self.gather_on_device:
            gids_pad = np.zeros(self.node_budget, np.int32)
            gids_pad[:len(gids)] = gids
            return g, y, seed_mask, gids_pad
        return g, y, seed_mask

    def __iter__(self) -> Iterator:
        order = self.seed_ids.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        base = self._batch_counter
        chunks = [(order[i:i + self.batch_size], base + k)
                  for k, i in enumerate(
                      range(0, len(order), self.batch_size))]
        self._batch_counter = base + len(chunks)
        from egc_tpu.data.prefetch import prefetched
        yield from prefetched(self._build, chunks, self.prefetch)
