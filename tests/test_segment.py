"""Segment-op parity tests vs hand-computed numpy semantics.

Semantics under test are the reference's torch_scatter behaviors
(empty segment -> 0, min = -max(-x), var/std = E[x^2]-E[x]^2 with
sqrt(relu(v)+1e-5)); see egc_tpu/ops/segment.py docstring.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from egc_tpu.ops import (
    segment_sum, segment_mean, segment_max, segment_min,
    segment_var, segment_std, segment_softmax, multi_aggregate,
)
from egc_tpu.graph.transforms import symnorm_weight


def np_segments(receivers, n):
    return [np.where(receivers == i)[0] for i in range(n)]


def make_graph(rng, n=11, e=40, f=5):
    senders = rng.integers(0, n, size=e).astype(np.int32)
    receivers = rng.integers(0, n, size=e).astype(np.int32)
    # Make node n-1 isolated (tests empty-segment semantics).
    senders[senders == n - 1] = 0
    receivers[receivers == n - 1] = 0
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, senders, receivers


def test_sum_mean_max_min_parity(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    g = x[s]
    segs = np_segments(r, n)

    def ref(op):
        out = np.zeros_like(x)
        for i, idx in enumerate(segs):
            if len(idx):
                out[i] = op(g[idx])
        return out

    np.testing.assert_allclose(
        segment_sum(jnp.array(g), jnp.array(r), n), ref(lambda v: v.sum(0)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        segment_mean(jnp.array(g), jnp.array(r), n), ref(lambda v: v.mean(0)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        segment_max(jnp.array(g), jnp.array(r), n), ref(lambda v: v.max(0)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        segment_min(jnp.array(g), jnp.array(r), n), ref(lambda v: v.min(0)),
        rtol=1e-5, atol=1e-5)


def test_empty_segments_are_zero(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    for fn in (segment_sum, segment_mean, segment_max, segment_min,
               segment_var, segment_std):
        out = np.asarray(fn(jnp.array(x[s]), jnp.array(r), n))
        if fn is segment_std:
            # std of empty segment = sqrt(0 + 1e-5)
            np.testing.assert_allclose(out[n - 1], np.sqrt(1e-5), rtol=1e-5)
        else:
            np.testing.assert_allclose(out[n - 1], 0.0, atol=1e-6)


def test_var_std_semantics(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    g = x[s]
    segs = np_segments(r, n)
    var_ref = np.zeros_like(x)
    for i, idx in enumerate(segs):
        if len(idx):
            var_ref[i] = (g[idx] ** 2).mean(0) - g[idx].mean(0) ** 2
    v = np.asarray(segment_var(jnp.array(g), jnp.array(r), n))
    np.testing.assert_allclose(v, var_ref, rtol=1e-4, atol=1e-5)
    st = np.asarray(segment_std(jnp.array(g), jnp.array(r), n))
    np.testing.assert_allclose(st, np.sqrt(np.maximum(var_ref, 0) + 1e-5),
                               rtol=1e-4, atol=1e-5)


def test_edge_mask_drops_edges(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    mask = rng.random(len(s)) > 0.3
    out = segment_sum(jnp.array(x[s]), jnp.array(r), n, mask=jnp.array(mask))
    ref = np.zeros_like(x)
    for j in range(len(s)):
        if mask[j]:
            ref[r[j]] += x[s[j]]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_segment_softmax(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    logits = rng.normal(size=(len(s),)).astype(np.float32)
    p = np.asarray(segment_softmax(jnp.array(logits), jnp.array(r), n))
    for i, idx in enumerate(np_segments(r, n)):
        if len(idx):
            e = np.exp(logits[idx] - logits[idx].max())
            np.testing.assert_allclose(p[idx], e / e.sum(), rtol=1e-5, atol=1e-6)
    # probabilities sum to 1 per non-empty segment
    sums = np.zeros(n)
    np.add.at(sums, r, p)
    nonempty = np.unique(r)
    np.testing.assert_allclose(sums[nonempty], 1.0, rtol=1e-5)


def test_multi_aggregate_matches_singles(rng):
    x, s, r = make_graph(rng)
    n = x.shape[0]
    xs, ss, rs = jnp.array(x), jnp.array(s), jnp.array(r)
    out = multi_aggregate(xs, ss, rs, ["sum", "mean", "max", "min", "var", "std"])
    g = xs[ss]
    singles = [
        segment_sum(g, rs, n), segment_mean(g, rs, n), segment_max(g, rs, n),
        segment_min(g, rs, n), segment_var(g, rs, n), segment_std(g, rs, n),
    ]
    for a, ref in enumerate(singles):
        np.testing.assert_allclose(out[:, a], ref, rtol=1e-5, atol=1e-5)


def test_multi_aggregate_include_self(rng):
    """Virtual self-loops must equal materialized self-loop edges."""
    x, s, r = make_graph(rng)
    n = x.shape[0]
    loop = np.arange(n, dtype=np.int32)
    s2, r2 = np.concatenate([s, loop]), np.concatenate([r, loop])
    xs = jnp.array(x)
    virt = multi_aggregate(xs, jnp.array(s), jnp.array(r),
                           ["sum", "mean", "max", "min", "var", "std"],
                           include_self=True)
    mat = multi_aggregate(xs, jnp.array(s2), jnp.array(r2),
                          ["sum", "mean", "max", "min", "var", "std"],
                          include_self=False)
    np.testing.assert_allclose(virt, mat, rtol=1e-5, atol=1e-5)


def test_symnorm_matches_materialized_gcn_norm(rng):
    """Virtual-self-loop symnorm == GCN norm with materialized self loops.

    Reference semantics: gcn_norm adds self-loops (weight 1), deg from
    receivers, w_ij = deg_i^-1/2 deg_j^-1/2, aggregation = weighted sum.
    """
    n = 9
    # undirected symmetric graph
    pairs = {(i, j) for i, j in zip(
        rng.integers(0, n, 30), rng.integers(0, n, 30)) if i != j}
    pairs |= {(j, i) for (i, j) in pairs}
    s = np.array([p[0] for p in sorted(pairs)], dtype=np.int32)
    r = np.array([p[1] for p in sorted(pairs)], dtype=np.int32)
    x = rng.normal(size=(n, 4)).astype(np.float32)

    # numpy reference with materialized self loops
    s2 = np.concatenate([s, np.arange(n, dtype=np.int32)])
    r2 = np.concatenate([r, np.arange(n, dtype=np.int32)])
    deg = np.zeros(n); np.add.at(deg, r2, 1.0)
    dis = 1.0 / np.sqrt(deg)
    w = dis[s2] * dis[r2]
    ref = np.zeros_like(x)
    for j in range(len(s2)):
        ref[r2[j]] += w[j] * x[s2[j]]

    ew, sw = symnorm_weight(jnp.array(s), jnp.array(r), n)
    out = multi_aggregate(jnp.array(x), jnp.array(s), jnp.array(r), ["symnorm"],
                          symnorm_edge_w=ew, symnorm_self_w=sw)[:, 0]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_aggr_aliases():
    from egc_tpu.ops import canonical_aggr
    assert canonical_aggr("add") == "sum"
    assert canonical_aggr("symadd") == "symnorm"
    with pytest.raises(ValueError):
        canonical_aggr("bogus")


def test_segment_max_custom_vjp_matches_autodiff(rng):
    """_segment_max_raw's packed-gather backward (the single-gather form — see
    ops.segment docstring) must equal jax.ops.segment_max's autodiff on
    tie-free data, for 1-D and 2-D values and masked ids."""
    from egc_tpu.ops.segment import _segment_max_raw, segment_max

    n, e = 23, 90
    ids = jnp.asarray(rng.integers(0, n, e).astype(np.int32))
    for shape in ((e,), (e, 5)):
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        proj = jnp.asarray(rng.normal(size=(n,) + shape[1:])
                           .astype(np.float32))

        def f_safe(v):
            return jnp.sum(_segment_max_raw(v, ids, n, False) * proj)

        def f_jax(v):
            return jnp.sum(jax.ops.segment_max(v, ids, num_segments=n)
                           * proj)

        np.testing.assert_allclose(np.asarray(jax.grad(f_safe)(x)),
                                   np.asarray(jax.grad(f_jax)(x)),
                                   rtol=1e-6, atol=1e-6)

    # masked path: masked entries must get zero gradient
    x = jnp.asarray(rng.normal(size=(e, 4)).astype(np.float32))
    mask = jnp.asarray(rng.random(e) > 0.4)
    proj = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(
        segment_max(v, ids, n, mask=mask) * proj))(x)
    assert np.abs(np.asarray(g)[~np.asarray(mask)]).max() == 0.0
