"""Segment (neighborhood) reductions — the framework's core primitive.

These are the JAX equivalents of the reference's native dependencies
``torch_scatter.scatter(..., reduce=...)`` and ``torch_sparse.matmul(adj_t,
x, reduce=...)`` (reference ``experiments/layers.py:201-225``,
``experiments/optimized_layers.py:215-278``). Semantics matched exactly:

- empty segments produce **0** for every reduction (torch_scatter zero-
  initializes its output);
- ``min(x) = -max(-x)`` (reference ``experiments/layers.py:190-191``);
- ``var = E[x^2] - E[x]^2`` via two mean-reductions, ``std =
  sqrt(relu(var) + 1e-5)`` (reference ``experiments/layers.py:201-216``);
- ``symnorm`` is a weighted sum with GCN symmetric-norm weights.

Deviation: self-loops are **virtual**. Instead of growing the edge
list (PyG ``add_remaining_self_loops``), the self contribution is folded
analytically: e.g. mean-with-self = (sum_neighbors + x_i) / (deg_i + 1).
Exactly equivalent for graphs without pre-existing self-loops, with static
shapes and one less gather per edge.

``multi_aggregate`` evaluates several aggregators in ONE pass over the edges
(single gather, shared partial sums) — the paper's "aggregator fusion"
(arXiv 2104.01481), which the reference deliberately does not implement
(``experiments/layers.py:67-70``). The convs reach it through
``egc_tpu.ops.dispatch.conv_aggregate``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

# Canonical aggregator names. The reference uses two naming schemes
# (`add/symadd` in layers.py vs `sum/symnorm` in optimized_layers.py:93);
# we canonicalize to the upstreamed names with aliases.
AGGREGATORS = ("sum", "mean", "max", "min", "var", "std", "symnorm")
_ALIASES = {"add": "sum", "symadd": "symnorm"}


def canonical_aggr(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; supported: {AGGREGATORS}")
    return name


def _masked_ids(segment_ids, num_segments: int, mask):
    """Map masked-out entries to an out-of-range id so XLA drops them."""
    if mask is None:
        return segment_ids
    return jnp.where(mask, segment_ids, num_segments)


def segment_sum(data, segment_ids, num_segments: int, *, mask=None,
                indices_are_sorted: bool = False):
    ids = _masked_ids(segment_ids, num_segments, mask)
    return jax.ops.segment_sum(
        data, ids, num_segments=num_segments,
        indices_are_sorted=indices_are_sorted and mask is None,
    )


def segment_count(segment_ids, num_segments: int, *, mask=None,
                  indices_are_sorted: bool = False, dtype=jnp.float32):
    ones = jnp.ones(segment_ids.shape[:1], dtype=dtype)
    return segment_sum(ones, segment_ids, num_segments, mask=mask,
                       indices_are_sorted=indices_are_sorted)


def segment_mean(data, segment_ids, num_segments: int, *, mask=None,
                 indices_are_sorted: bool = False):
    s = segment_sum(data, segment_ids, num_segments, mask=mask,
                    indices_are_sorted=indices_are_sorted)
    cnt = segment_count(segment_ids, num_segments, mask=mask,
                        indices_are_sorted=indices_are_sorted, dtype=s.dtype)
    cnt = jnp.maximum(cnt, 1.0)
    return s / cnt.reshape(cnt.shape + (1,) * (s.ndim - 1))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _segment_max_raw(data, ids, num_segments, indices_are_sorted):
    """``jax.ops.segment_max`` with a single-gather custom VJP.

    Autodiff's scatter-max backward needs two SAME-INDEX gathers (the
    segment maxima and the cotangent, both at ``ids``); the custom
    backward packs both operands into ONE gather, so a compiler cannot
    pair the two gathers wrongly (such a mis-merge was once seen on
    another backend).

    Tie semantics: the FULL cotangent is routed to every achieving
    element instead of autodiff's even split — identical on coalesced
    graphs with continuous features.
    """
    return jax.ops.segment_max(data, ids, num_segments=num_segments,
                               indices_are_sorted=indices_are_sorted)


def _segment_max_raw_fwd(data, ids, num_segments, indices_are_sorted):
    out = _segment_max_raw(data, ids, num_segments, indices_are_sorted)
    return out, (data, ids, out)


def _segment_max_raw_bwd(num_segments, indices_are_sorted, res, ct):
    data, ids, out = res
    e = data.shape[0]
    d2 = data.reshape(e, -1)
    f = d2.shape[1]
    packed = jnp.concatenate(
        [out.reshape(num_segments, f), ct.reshape(num_segments, f)], axis=1)
    rows = jnp.take(packed, jnp.minimum(ids, num_segments - 1), axis=0)
    achieved = (d2 == rows[:, :f]) & (ids < num_segments)[:, None]
    d_data = jnp.where(achieved, rows[:, f:], 0.0).reshape(data.shape)
    return d_data, np.zeros(ids.shape, jax.dtypes.float0)


_segment_max_raw.defvjp(_segment_max_raw_fwd, _segment_max_raw_bwd)


def segment_max(data, segment_ids, num_segments: int, *, mask=None,
                indices_are_sorted: bool = False, empty_value=0.0):
    ids = _masked_ids(segment_ids, num_segments, mask)
    out = _segment_max_raw(
        data, ids, num_segments,
        indices_are_sorted and mask is None,
    )
    cnt = segment_count(segment_ids, num_segments, mask=mask)
    has = (cnt > 0).reshape(cnt.shape + (1,) * (out.ndim - 1))
    return jnp.where(has, out, jnp.asarray(empty_value, out.dtype))


def segment_min(data, segment_ids, num_segments: int, *, mask=None,
                indices_are_sorted: bool = False, empty_value=0.0):
    # min = -max(-x): parity with reference experiments/layers.py:190-191.
    return -segment_max(-data, segment_ids, num_segments, mask=mask,
                        indices_are_sorted=indices_are_sorted,
                        empty_value=-empty_value)


def _var_from_moments(msq, m):
    """``E[x^2] - E[x]^2`` forced to ONE materialized value.

    The subtraction cancels catastrophically when var ~ 0 (e.g. a segment
    of near-equal values). Without the barrier a compiler may
    rematerialize it per consumer with different FMA contraction, and the
    two copies can round to OPPOSITE signs — the forward relu gate and the
    backward relu' gate then disagree, which leaves one of the two large
    (mutually-cancelling) VJP branches unopposed and inflates std
    gradients by ~1/sqrt(eps). The barrier pins every consumer — sqrt,
    relu', both cotangent branches — to the same bits."""
    return jax.lax.optimization_barrier(msq - m * m)


def _make_varstd_edges(ids, counts, num_segments: int, include_self: bool,
                       want_std: bool, sorted_hint: bool):
    """Segment var/std over edge-gathered values with a STABLE custom VJP.

    Forward keeps exact reference semantics (``E[x^2] - E[x]^2``,
    ``std = sqrt(relu(var) + 1e-5)``, reference
    ``experiments/layers.py:201-216``). The backward is rewritten in the
    mathematically identical factored form

        d_gathered[e] = 2 (gathered[e] - m[r]) * dvar[r] / denom[r]

    instead of autodiff's pair of branch cotangents (``2 x * c_sumsq`` and
    ``c_sum``), whose ~1/sqrt(eps)-amplified terms must cancel in fp32.
    If ``var = msq - m*m`` is rematerialized per fusion with different FMA
    contraction, at var ~ 0 the copies can round to opposite signs: the
    relu' gate of one branch closes while the other stays open, and the
    uncancelled branch inflates the gradient by orders of magnitude. In
    the factored form a gate flip only toggles a term bounded by
    ``~158 |x - m|``, which is tiny exactly where flips can happen.

    ``ids`` may contain out-of-range entries (masked edges); their
    cotangent contribution is forced to zero with a fill-gather.
    Returns a function ``f(gathered, node_vals) -> [N, F] var-or-std``.
    """
    denom0 = jnp.maximum(counts + (1.0 if include_self else 0.0), 1.0)
    ids_safe = jnp.minimum(ids, num_segments - 1)
    valid0 = (ids < num_segments).astype(jnp.float32)

    def _bcast(v, ndim):
        return v.reshape(v.shape + (1,) * (ndim - 1))

    def _moments(gathered, node_vals):
        denom = _bcast(denom0, gathered.ndim)
        s = jax.ops.segment_sum(gathered, ids, num_segments=num_segments,
                                indices_are_sorted=sorted_hint)
        sq = jax.ops.segment_sum(gathered * gathered, ids,
                                 num_segments=num_segments,
                                 indices_are_sorted=sorted_hint)
        if include_self:
            s = s + node_vals
            sq = sq + node_vals * node_vals
        m = s / denom
        msq = sq / denom
        return m, _var_from_moments(msq, m)

    @jax.custom_vjp
    def f(gathered, node_vals):
        _, var = _moments(gathered, node_vals)
        return jnp.sqrt(jax.nn.relu(var) + 1e-5) if want_std else var

    def f_fwd(gathered, node_vals):
        m, var = _moments(gathered, node_vals)
        out = jnp.sqrt(jax.nn.relu(var) + 1e-5) if want_std else var
        return out, (gathered, node_vals, m, var, out)

    def f_bwd(res, ct):
        gathered, node_vals, m, var, out = res
        gate = (var > 0).astype(ct.dtype)
        dvar = ct * gate * (0.5 / out) if want_std else ct
        coeff = 2.0 * dvar / _bcast(denom0, ct.ndim)     # [N, ...]
        # ONE gather for both per-receiver operands: packing (m, coeff)
        # into one array leaves a single gather op to fuse (two same-index
        # gathers here were once mis-merged by a compiler, squaring the
        # ~1/sqrt(eps) factor).
        pack = jnp.stack([m, coeff], axis=1)             # [N, 2, ...]
        ge = jnp.take(pack, ids_safe, axis=0)            # [E, 2, ...]
        ce = ge[:, 1] * _bcast(valid0, ct.ndim)
        d_gathered = (gathered - ge[:, 0]) * ce
        if include_self:
            d_node = (node_vals - m) * coeff
        else:
            d_node = jnp.zeros_like(node_vals)
        return d_gathered, d_node

    f.defvjp(f_fwd, f_bwd)
    return f


def _varstd_dispatch(data, segment_ids, num_segments, mask,
                     indices_are_sorted, want_std):
    ids = _masked_ids(segment_ids, num_segments, mask)
    counts = segment_count(segment_ids, num_segments, mask=mask,
                           indices_are_sorted=indices_are_sorted,
                           dtype=data.dtype)
    f = _make_varstd_edges(
        ids, counts, num_segments, include_self=False, want_std=want_std,
        sorted_hint=indices_are_sorted and mask is None)
    zeros = jnp.zeros((num_segments,) + data.shape[1:], data.dtype)
    return f(data, zeros)


def segment_var(data, segment_ids, num_segments: int, *, mask=None,
                indices_are_sorted: bool = False):
    return _varstd_dispatch(data, segment_ids, num_segments, mask,
                            indices_are_sorted, want_std=False)


def segment_std(data, segment_ids, num_segments: int, *, mask=None,
                indices_are_sorted: bool = False, eps: float = 1e-5):
    # sqrt(relu(var) + 1e-5): reference experiments/layers.py:214-216.
    del eps  # fixed reference epsilon inside the stable kernel
    return _varstd_dispatch(data, segment_ids, num_segments, mask,
                            indices_are_sorted, want_std=True)


def segment_softmax(logits, segment_ids, num_segments: int, *, mask=None,
                    indices_are_sorted: bool = False):
    """Numerically-stable softmax within each segment (per-receiver, for GAT).

    Masked entries get probability 0; empty segments yield all-zero rows.
    """
    ids = _masked_ids(segment_ids, num_segments, mask)
    neg_big = jnp.asarray(jnp.finfo(logits.dtype).min, logits.dtype)
    mx = _segment_max_raw(logits, ids, num_segments,
                          indices_are_sorted and mask is None)
    mx = jnp.where(jnp.isfinite(mx), mx, jnp.zeros_like(mx))
    shifted = logits - mx[segment_ids]
    ex = jnp.exp(shifted)
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (ex.ndim - 1))
        ex = jnp.where(m, ex, jnp.zeros_like(ex))
    denom = jax.ops.segment_sum(ex, ids, num_segments=num_segments)
    denom = jnp.maximum(denom, jnp.asarray(jnp.finfo(logits.dtype).tiny, logits.dtype))
    del neg_big
    return ex / denom[segment_ids]


NEG_BIG = -3.0e38


def segment_primitives(
    src_vals,                      # [M, F] sender-side values
    senders,                       # [E] indices into src_vals
    receivers,                     # [E] indices into [num_segments)
    prims: Sequence[str],          # ⊆ {sum, wsum, sumsq, max, min, count}
    num_segments: int,
    *,
    edge_mask=None,
    edge_w=None,                   # [E] weights for "wsum"
    indices_are_sorted: bool = False,
):
    """Edge-sweep primitives as a dict — the decomposable layer underneath
    ``multi_aggregate``. Partial results over edge SUBSETS combine exactly:
    sum/wsum/sumsq/count add, max/min combine via max/min (empty segments
    hold +-NEG_BIG until assembly). Used by the overlapped halo-exchange
    path (interior + boundary partials) and shared with the fused-kernel
    assembly."""
    gathered = jnp.take(src_vals, senders, axis=0)
    sorted_hint = indices_are_sorted and edge_mask is None
    ids = _masked_ids(receivers, num_segments, edge_mask)
    out = {}
    for p in prims:
        if p == "sum":
            out[p] = jax.ops.segment_sum(gathered, ids,
                                         num_segments=num_segments,
                                         indices_are_sorted=sorted_hint)
        elif p == "wsum":
            w = edge_w[:, None].astype(gathered.dtype)
            out[p] = jax.ops.segment_sum(gathered * w, ids,
                                         num_segments=num_segments,
                                         indices_are_sorted=sorted_hint)
        elif p == "sumsq":
            out[p] = jax.ops.segment_sum(gathered * gathered, ids,
                                         num_segments=num_segments,
                                         indices_are_sorted=sorted_hint)
        elif p == "count":
            out[p] = segment_count(receivers, num_segments, mask=edge_mask,
                                   indices_are_sorted=indices_are_sorted,
                                   dtype=src_vals.dtype)
        elif p == "max":
            out[p] = _segment_max_raw(gathered, ids, num_segments,
                                      sorted_hint)
        elif p == "min":
            out[p] = -_segment_max_raw(-gathered, ids, num_segments,
                                       sorted_hint)
        else:  # pragma: no cover
            raise ValueError(p)
    return out


def combine_primitives(a: dict, b: dict) -> dict:
    """Exact combination of primitive partials over disjoint edge subsets."""
    out = {}
    for k in a:
        if k in ("max",):
            out[k] = jnp.maximum(a[k], b[k])
        elif k in ("min",):
            out[k] = jnp.minimum(a[k], b[k])
        else:
            out[k] = a[k] + b[k]
    return out


def prims_needed(aggrs: Sequence[str]):
    """The primitive set an aggregator list requires."""
    needs = {canonical_aggr(a) for a in aggrs}
    prims = []
    if needs & {"sum", "mean", "var", "std"}:
        prims.append("sum")
    if "symnorm" in needs:
        prims.append("wsum")
    if needs & {"var", "std"}:
        prims.append("sumsq")
    if needs & {"mean", "max", "min", "var", "std"}:
        prims.append("count")
    if "max" in needs:
        prims.append("max")
    if "min" in needs:
        prims.append("min")
    return tuple(prims)


def assemble_aggregators(
    p: dict,                       # primitives (see segment_primitives)
    node_vals,                     # [N, F] self values (for virtual loops)
    aggrs: Sequence[str],
    *,
    include_self: bool = False,
    symnorm_self_w=None,
):
    """Node-level assembly of final aggregators from primitives — same
    semantics as ``multi_aggregate`` (empty -> 0, min=-max(-x), std eps).
    Returns [N, A, F]."""
    aggrs = [canonical_aggr(a) for a in aggrs]
    counts = p.get("count")
    outs = []
    for a in aggrs:
        if a == "sum":
            out = p["sum"] + node_vals if include_self else p["sum"]
        elif a == "mean":
            if include_self:
                out = (p["sum"] + node_vals) / \
                    jnp.maximum(counts + 1.0, 1.0)[:, None]
            else:
                out = p["sum"] / jnp.maximum(counts, 1.0)[:, None]
        elif a == "max":
            has = (counts > 0)[:, None]
            if include_self:
                out = jnp.maximum(jnp.where(has, p["max"], node_vals),
                                  node_vals)
            else:
                out = jnp.where(has, p["max"], jnp.zeros_like(node_vals))
        elif a == "min":
            has = (counts > 0)[:, None]
            if include_self:
                out = jnp.minimum(jnp.where(has, p["min"], node_vals),
                                  node_vals)
            else:
                out = jnp.where(has, p["min"], jnp.zeros_like(node_vals))
        elif a in ("var", "std"):
            if include_self:
                denom = jnp.maximum(counts + 1.0, 1.0)[:, None]
                m = (p["sum"] + node_vals) / denom
                msq = (p["sumsq"] + node_vals * node_vals) / denom
            else:
                denom = jnp.maximum(counts, 1.0)[:, None]
                m = p["sum"] / denom
                msq = p["sumsq"] / denom
            out = _var_from_moments(msq, m)
            if a == "std":
                out = jnp.sqrt(jax.nn.relu(out) + 1e-5)
        elif a == "symnorm":
            out = p["wsum"]
            if symnorm_self_w is not None:
                out = out + symnorm_self_w[:, None].astype(out.dtype) * \
                    node_vals
        else:  # pragma: no cover
            raise ValueError(a)
        outs.append(out)
    return jnp.stack(outs, axis=1)


def multi_aggregate(
    node_vals,                     # [N, F] values to aggregate (e.g. bases)
    senders,                       # [E]
    receivers,                     # [E]
    aggrs: Sequence[str],
    *,
    edge_mask=None,                # [E] bool
    include_self: bool = False,    # virtual self-loop for non-symnorm aggrs
    symnorm_edge_w=None,           # [E] (required if 'symnorm' in aggrs)
    symnorm_self_w=None,           # [N] (0s when symnorm has no self-loops)
    indices_are_sorted: bool = False,
    gathered=None,                 # optional precomputed node_vals[senders]
):
    """Fused multi-aggregator neighborhood reduction.

    Returns ``[N, A, F]`` stacked in the order of ``aggrs`` — the shape
    contract of the reference's ``EGConv.aggregate`` (reference
    ``experiments/optimized_layers.py:215-249``).

    ``include_self`` mirrors the two reference behaviors:
      - paper layer (``experiments/layers.py``): self-loops ONLY inside
        symnorm's gcn_norm ⇒ ``include_self=False`` + nonzero
        ``symnorm_self_w``;
      - upstreamed ``EGConv`` (``optimized_layers.py:158-175``): self-loops
        for every aggregator ⇒ ``include_self=True``.
    """
    aggrs = [canonical_aggr(a) for a in aggrs]
    num_segments = node_vals.shape[0]
    if gathered is None:
        gathered = jnp.take(node_vals, senders, axis=0)

    sorted_hint = indices_are_sorted and edge_mask is None
    ids = _masked_ids(receivers, num_segments, edge_mask)

    needs = set(aggrs)
    # Shared partial results.
    seg_sum = None
    if needs & {"sum", "mean", "var", "std"}:
        seg_sum = jax.ops.segment_sum(gathered, ids, num_segments=num_segments,
                                      indices_are_sorted=sorted_hint)
    counts = None
    if needs & {"mean", "max", "min", "var", "std"}:
        counts = segment_count(receivers, num_segments, mask=edge_mask,
                               indices_are_sorted=indices_are_sorted,
                               dtype=node_vals.dtype)
    # var/std run through the stable-VJP helper (which recomputes their
    # segment sums; XLA CSEs them with seg_sum above when both appear)

    outs = []
    for a in aggrs:
        if a == "sum":
            out = seg_sum + node_vals if include_self else seg_sum
        elif a == "mean":
            if include_self:
                out = (seg_sum + node_vals) / jnp.maximum(counts + 1.0, 1.0)[:, None]
            else:
                out = seg_sum / jnp.maximum(counts, 1.0)[:, None]
        elif a == "max":
            mx = _segment_max_raw(gathered, ids, num_segments, sorted_hint)
            if include_self:
                out = jnp.maximum(jnp.where((counts > 0)[:, None], mx, node_vals),
                                  node_vals)
            else:
                out = jnp.where((counts > 0)[:, None], mx,
                                jnp.zeros_like(node_vals))
        elif a == "min":
            mn = -_segment_max_raw(-gathered, ids, num_segments,
                                   sorted_hint)
            if include_self:
                out = jnp.minimum(jnp.where((counts > 0)[:, None], mn, node_vals),
                                  node_vals)
            else:
                out = jnp.where((counts > 0)[:, None], mn,
                                jnp.zeros_like(node_vals))
        elif a in ("var", "std"):
            out = _make_varstd_edges(
                ids, counts, num_segments, include_self,
                want_std=(a == "std"), sorted_hint=sorted_hint,
            )(gathered, node_vals)
        elif a == "symnorm":
            if symnorm_edge_w is None:
                raise ValueError("symnorm aggregator requires symnorm_edge_w")
            w = symnorm_edge_w[:, None].astype(gathered.dtype)
            out = jax.ops.segment_sum(gathered * w, ids,
                                      num_segments=num_segments,
                                      indices_are_sorted=sorted_hint)
            if symnorm_self_w is not None:
                out = out + symnorm_self_w[:, None].astype(out.dtype) * node_vals
        else:  # pragma: no cover
            raise ValueError(a)
        outs.append(out)

    return jnp.stack(outs, axis=1)
