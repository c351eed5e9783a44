"""Graph preprocessing transforms.

Host-side (numpy, at ingestion time): dedup / undirected / self-loop removal.
Device-side (jnp, jit-safe): degree and GCN symmetric-normalization weights.

Self-loop policy (a design decision): the reference *materializes*
self-loop edges (PyG ``add_remaining_self_loops`` /
``gcn_norm(add_self_loops=True)``, reference ``experiments/layers.py:165-188``,
``experiments/optimized_layers.py:126-175``). Growing an edge list inside a
jitted program would break static shapes, so this framework keeps the edge
list fixed and folds the self-loop contribution *analytically* into each
segment reduction ("virtual self-loops", see ``egc_tpu.ops.segment``). The
functions here therefore assume graphs carry **no** explicit self-loops; call
``remove_self_loops_np`` at ingestion.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Host-side (ingestion-time) transforms.
# ---------------------------------------------------------------------------

def remove_self_loops_np(senders: np.ndarray, receivers: np.ndarray, *extras):
    """Drop i->i edges (and matching rows of any per-edge extras)."""
    keep = senders != receivers
    out = [senders[keep], receivers[keep]]
    for x in extras:
        out.append(None if x is None else x[keep])
    return tuple(out)


def coalesce_np(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """Sort edges by (receiver, sender) and drop duplicates.

    Sorting by receiver gives the CSC-like layout the segment reductions
    exploit (`indices_are_sorted=True`); matches the reference's permutation
    sort by ``col * N + row`` (reference ``experiments/utils.py:93``).
    """
    key = receivers.astype(np.int64) * num_nodes + senders.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    idx = order[keep]
    return senders[idx].astype(np.int32), receivers[idx].astype(np.int32), idx


def to_undirected_np(senders: np.ndarray, receivers: np.ndarray, num_nodes: int):
    """Symmetrize: union of edges and reversed edges, deduplicated + sorted."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    s, r, _ = coalesce_np(s, r, num_nodes)
    return s, r


def sort_edges_by_receiver_np(senders, receivers, *extras, num_nodes: int):
    """Stable sort edges by (receiver, sender) without dedup."""
    key = receivers.astype(np.int64) * num_nodes + senders.astype(np.int64)
    order = np.argsort(key, kind="stable")
    out = [senders[order].astype(np.int32), receivers[order].astype(np.int32)]
    for x in extras:
        out.append(None if x is None else x[order])
    out.append(order)
    return tuple(out)


# ---------------------------------------------------------------------------
# Device-side (jit-safe) computations.
# ---------------------------------------------------------------------------

def in_degree(receivers, num_nodes: int, edge_mask=None, dtype=jnp.float32):
    """Number of (valid) incoming edges per node, excluding virtual self-loops."""
    ones = jnp.ones_like(receivers, dtype=dtype)
    if edge_mask is not None:
        ones = jnp.where(edge_mask, ones, jnp.zeros_like(ones))
    return jnp.zeros((num_nodes,), dtype).at[receivers].add(ones)


def symnorm_weight(
    senders,
    receivers,
    num_nodes: int,
    *,
    edge_mask=None,
    add_self_loops: bool = True,
    dtype=jnp.float32,
):
    """GCN symmetric normalization weights (PyG ``gcn_norm`` semantics).

    Returns ``(edge_w [E], self_w [N])`` where aggregation is
    ``out_i = self_w[i] * x_i + sum_j edge_w[ij] * x_j`` — the self-loop term
    the reference materializes as extra edges (reference
    ``experiments/layers.py:172-178``) is returned separately for the virtual
    self-loop fold. With ``add_self_loops=False``, ``self_w`` is zeros.

    deg_i = (#non-loop in-edges of i) + 1[self loops];
    w_ij = deg_i^-1/2 deg_j^-1/2.
    Assumes a symmetric graph (as all symnorm call sites in the reference do)
    so sender/receiver degree coincide.

    Pre-existing self-loop edges are DEDUPED into the single canonical
    self-loop when ``add_self_loops=True`` (their edge weight is zeroed and
    they do not count toward the degree), matching the reference's
    ``gcn_norm`` -> ``add_remaining_self_loops`` semantics (PyG drops
    existing loops and appends exactly one per node) — gated by
    tests/test_reference_exec.py against the executing reference code.
    """
    if add_self_loops:
        # dedup: existing loop edges are replaced by the canonical loop
        nonloop = senders != receivers
        dmask = nonloop if edge_mask is None else (edge_mask & nonloop)
    else:
        dmask = edge_mask
    deg = in_degree(receivers, num_nodes, dmask, dtype)
    if add_self_loops:
        deg = deg + 1.0
    inv_sqrt = jnp.where(deg > 0, jax_rsqrt(deg), jnp.zeros_like(deg))
    edge_w = inv_sqrt[senders] * inv_sqrt[receivers]
    if dmask is not None:
        edge_w = jnp.where(dmask, edge_w, jnp.zeros_like(edge_w))
    if add_self_loops:
        self_w = inv_sqrt * inv_sqrt  # = 1 / deg
    else:
        self_w = jnp.zeros((num_nodes,), dtype)
    return edge_w, self_w


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(x)
