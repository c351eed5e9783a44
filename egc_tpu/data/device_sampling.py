"""On-device neighbor sampling (VERDICT r4 item 6).

The host sampler (:mod:`egc_tpu.data.sampling`) runs on the host, so the
device can idle behind it. This module moves the whole layered sample onto
the device as ONE jitted program over static budgets:

- The graph's in-edge CSR (``rowptr``, ``in_senders``) lives on the
  device once.
- Per hop, every frontier node draws an EXACT uniform without-replacement
  ``fanout``-subset of its in-edges via a vectorized Floyd sampler
  (k iterations of draw-and-remap; membership checks are [fb, k] compares
  — k is tiny). Same distribution as the host sampler's keep-k-smallest-
  keys scheme (both are uniform k-subsets; realizations differ by PRNG).
- New nodes get dense local ids by sort -> run-starts -> cumsum ranks
  (static worst-case budgets, same as ``NeighborSampler.budgets``); a
  [num_nodes+1] scatter table maps global -> local ids per batch.
- Output mirrors ``SampledNodeLoader(gather_on_device=True)``: a padded
  zero-width-feature :class:`Graph`, padded global-id list (sentinel
  ``num_nodes`` on padding), labels/seed-mask — the train step gathers
  features from the device-resident matrix exactly as before.

Everything is ``lax``-friendly: python loops run over the STATIC hop/slot
structure, so the program compiles once per batch size.

Distributed note: under sampling-DP, run one sampler per device inside
``shard_map`` with per-device ``jax.random.fold_in`` seed streams; the
CSR arrays are replicated (they are read-only) and gradients psum as in
``parallel.dp``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from egc_tpu.graph.structure import Graph


def as_graph(gids, s, r, em, nm, *, x_width: int = 0) -> Graph:
    """Wrap sampler outputs as a Graph (jit-composable: plain pytree)."""
    nb = nm.shape[0]
    return Graph(
        nodes=jnp.zeros((nb, x_width), jnp.float32),
        senders=s, receivers=r,
        node_mask=nm, edge_mask=em,
        graph_ids=jnp.zeros((nb,), jnp.int32),
        graph_mask=jnp.ones((1,), bool),
    )


def _floyd_subset(key, deg, k: int):
    """Per-row uniform without-replacement k-subset of [0, deg).

    Floyd's algorithm, vectorized over rows: for j = 0..k-1 draw
    t ~ U[0, deg-k+j], replace with deg-k+j on collision with earlier
    picks. Rows with deg <= k take slots 0..deg-1 (all edges, CSR order).
    Returns (sel [R, k] int32, slot_valid [R, k] bool).
    """
    r = deg.shape[0]
    deg = deg.astype(jnp.int32)
    sel = jnp.zeros((r, k), jnp.int32)
    for j in range(k):
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (r,))
        i_val = deg - k + j                       # >= 0 iff deg >= k - j
        t = jnp.minimum(jnp.floor(u * (i_val + 1)).astype(jnp.int32),
                        jnp.maximum(i_val, 0))
        if j:
            member = jnp.any(sel[:, :j] == t[:, None], axis=1)
            t = jnp.where(member, i_val, t)
        pick = jnp.where(deg <= k, j, t)
        sel = sel.at[:, j].set(pick)
    slot_valid = jnp.arange(k)[None, :] < jnp.minimum(deg, k)[:, None]
    return sel, slot_valid


class DeviceNeighborSampler:
    """Layered in-neighbor sampler running entirely on device.

    Same sampling contract as :class:`egc_tpu.data.sampling.
    NeighborSampler` (in-edges of the frontier, exact without-replacement
    per receiver, loss seeds in local slots [0, batch)); the sample is one
    jitted call per (batch_size,) signature.
    """

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int, fanouts: Sequence[int] = (10, 5)):
        self.num_nodes = int(num_nodes)
        self.fanouts = tuple(int(f) for f in fanouts)
        order = np.argsort(receivers, kind="stable")
        self._in_senders = jnp.asarray(senders[order].astype(np.int32))
        self._rowptr = jnp.asarray(
            np.searchsorted(receivers[order],
                            np.arange(num_nodes + 1)).astype(np.int32))
        # per-instance closure/jit cache (a functools.lru_cache on bound
        # methods would pin every sampler instance — and its device CSR
        # arrays — for the process lifetime)
        self._cache = {}

    def budgets(self, batch_size: int) -> Tuple[int, int]:
        """Worst-case (nodes, edges) — identical to the host sampler."""
        nodes, frontier, edges = batch_size, batch_size, 0
        for f in self.fanouts:
            edges += frontier * f
            frontier = frontier * f
            nodes += frontier
        return nodes + 1, edges

    def padded_budgets(self, batch_size: int,
                       node_multiple: int = 8) -> Tuple[int, int]:
        nb, eb = self.budgets(batch_size)
        nb = ((nb + node_multiple - 1) // node_multiple) * node_multiple
        eb = ((eb + 127) // 128) * 128
        return nb, eb

    def _fn(self, batch_size: int, node_multiple: int = 8):
        key = ("jit", batch_size, node_multiple)
        if key not in self._cache:
            self._cache[key] = jax.jit(self.raw(batch_size, node_multiple))
        return self._cache[key]

    def raw(self, batch_size: int, node_multiple: int = 8):
        """UNJITTED sample closure — compose it INSIDE a jitted train step
        (one device call per batch instead of a separate dispatch).

        Signature: ``sample(key, seeds, rowptr, in_senders)`` — the CSR
        arrays are ARGUMENTS, never closure constants (a mag-scale edge
        array baked into the program as a constant bloats compilation).
        Pass ``self.csr`` through the caller's jit boundary."""
        key = ("raw", batch_size, node_multiple)
        if key in self._cache:
            return self._cache[key]
        N = self.num_nodes
        fanouts = self.fanouts
        node_budget, edge_budget = self.padded_budgets(batch_size,
                                                       node_multiple)
        i32 = jnp.int32
        pad_node = node_budget - 1

        def sample(key, seeds, rowptr, in_senders):
            """seeds [batch_size] int32; padded slots carry sentinel N."""
            S = batch_size
            seed_ok = seeds < N
            loc = jnp.full(N + 1, -1, i32)
            loc = loc.at[jnp.where(seed_ok, seeds, N + 1)].set(
                jnp.arange(S, dtype=i32), mode="drop")
            gids = jnp.full(node_budget, N, i32).at[:S].set(seeds)
            n_cur = jnp.asarray(S, i32)

            f = seeds                               # frontier gids [fb]
            floc = jnp.arange(S, dtype=i32)         # frontier local ids
            fb = S
            es, er, em = [], [], []
            for fanout in fanouts:
                fvalid = f < N
                fc = jnp.minimum(f, N - 1)
                deg = jnp.where(fvalid, rowptr[fc + 1] - rowptr[fc], 0)
                key, sub = jax.random.split(key)
                sel, slot_ok = _floyd_subset(sub, deg, fanout)
                eidx = jnp.minimum(rowptr[fc][:, None] + sel,
                                   in_senders.shape[0] - 1)
                u = in_senders[eidx]                # [fb, fanout]
                valid = slot_ok & fvalid[:, None]
                u = jnp.where(valid, u, N)

                # dense local ids for first-seen senders
                cand = jnp.where(valid & (loc[u] < 0), u, N).reshape(-1)
                ss = jnp.sort(cand)
                isnew = (ss < N) & jnp.concatenate(
                    [jnp.ones((1,), bool), ss[1:] != ss[:-1]])
                ranks = (jnp.cumsum(isnew) - 1).astype(i32)
                n_new = jnp.sum(isnew).astype(i32)
                loc = loc.at[jnp.where(isnew, ss, N + 1)].set(
                    n_cur + ranks, mode="drop")
                gids = gids.at[jnp.where(isnew, n_cur + ranks,
                                         node_budget)].set(ss, mode="drop")

                s_loc = loc[u]                      # after update
                es.append(jnp.where(valid, s_loc,
                                    pad_node).reshape(-1))
                er.append(jnp.where(valid, floc[:, None],
                                    pad_node).reshape(-1))
                em.append(valid.reshape(-1))

                nfb = fb * fanout
                f = jnp.full(nfb, N, i32).at[
                    jnp.where(isnew, ranks, nfb)].set(ss, mode="drop")
                floc = n_cur + jnp.arange(nfb, dtype=i32)
                fb = nfb
                n_cur = n_cur + n_new

            s_all = jnp.concatenate(es)
            r_all = jnp.concatenate(er)
            m_all = jnp.concatenate(em)
            pad_e = edge_budget - s_all.shape[0]
            s_all = jnp.pad(s_all, (0, pad_e), constant_values=pad_node)
            r_all = jnp.pad(r_all, (0, pad_e), constant_values=pad_node)
            m_all = jnp.pad(m_all, (0, pad_e))
            node_mask = (jnp.arange(node_budget) <
                         n_cur) & (gids < N)
            return gids, s_all, r_all, m_all, node_mask, n_cur

        self._cache[key] = sample
        return sample

    @property
    def csr(self):
        """(rowptr, in_senders) device arrays for the raw() signature."""
        return self._rowptr, self._in_senders

    def sample(self, key, seeds: jnp.ndarray):
        """One device-side sample. ``seeds``: [S] int32 (sentinel
        ``num_nodes`` pads a short final batch). Returns
        (gids [node_budget], senders/receivers/edge_mask [edge_budget],
        node_mask, n_nodes)."""
        return self._fn(int(seeds.shape[0]))(key, seeds, self._rowptr,
                                             self._in_senders)

    def sample_graph(self, key, seeds, *, x_width: int = 0):
        """Sample and wrap as a padded zero-width-feature Graph + gids,
        mirroring ``SampledNodeLoader(gather_on_device=True)`` items."""
        gids, s, r, em, nm, _ = self.sample(key, seeds)
        return as_graph(gids, s, r, em, nm, x_width=x_width), gids


class DeviceSampledLoader:
    """Epoch iterator over device-side sampled batches.

    Yields (graph, y, seed_mask, gids) — the exact item contract of
    ``SampledNodeLoader(gather_on_device=True)`` — with labels gathered on
    device from the resident label vector. Shuffling is host-side (seed id
    permutation only); everything per-batch is device compute.
    """

    def __init__(self, sampler: DeviceNeighborSampler, y: np.ndarray,
                 seed_ids: np.ndarray, batch_size: int, *,
                 shuffle: bool = True, rng_seed: int = 0):
        self.sampler = sampler
        self.y_full = jnp.asarray(np.asarray(y))
        self.seed_ids = np.asarray(seed_ids)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(rng_seed)
        self._key = jax.random.key(rng_seed)
        nb, _ = sampler.padded_budgets(batch_size)
        self._seed_mask_tmpl = jnp.arange(nb) < batch_size

    def __len__(self):
        return (len(self.seed_ids) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self.seed_ids.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        N = self.sampler.num_nodes
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            n_seed = len(chunk)
            seeds = np.full(self.batch_size, N, np.int32)
            seeds[:n_seed] = chunk
            self._key, sub = jax.random.split(self._key)
            g, gids = self.sampler.sample_graph(sub, jnp.asarray(seeds))
            y = self.y_full[jnp.minimum(gids, N - 1)]
            seed_mask = self._seed_mask_tmpl & g.node_mask
            yield g, y, seed_mask, gids
