"""conv_aggregate and the attention convs against float64 numpy oracles.

The aggregation path every conv takes (``ops.dispatch.conv_aggregate`` ->
``ops.segment.multi_aggregate``) is checked for values and gradients at
the aggregator sets the models use (1, 3 and 6 aggregators), at the
widths 128, 136 and 256, with and without the virtual self-loop
(``include_self``), on a padded graph with masked edges and empty
segments. GAT/GATv2 are checked at the arxiv head layouts (h152 H8,
h112 H8, h128 H4) on the same kind of graph.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from egc_tpu.graph.structure import Graph, pad_graph
from egc_tpu.graph.transforms import coalesce_np, symnorm_weight
from egc_tpu.nn.conv.attention import GATConv, GATv2Conv
from egc_tpu.ops.dispatch import conv_aggregate

SETS = {
    "1": ("symnorm",),
    "3": ("symnorm", "max", "mean"),
    "6": ("sum", "mean", "max", "min", "std", "symnorm"),
}
WIDTHS = (128, 136, 256)


def padded_graph(rng, n=160, e=900, masked=0.2):
    """Coalesced random graph, padded by 8 nodes and to a 128-multiple edge
    budget, with a fraction of real edges masked out. Nodes of the last
    quarter receive no edge (empty segments)."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, 3 * n // 4, e).astype(np.int32)
    keep = s != r
    s, r, _ = coalesce_np(s[keep], r[keep], n)
    g = Graph.from_coo(np.zeros((n, 1), np.float32), s, r)
    g = pad_graph(g, num_nodes=n + 8,
                  num_edges=((len(s) + 127) // 128 + 1) * 128)
    em = np.asarray(g.edge_mask).copy()
    em[:len(s)] &= rng.random(len(s)) >= masked
    return jax.tree.map(jnp.asarray, g.replace(edge_mask=em))


def _valid_edges(g):
    em = np.asarray(g.edge_mask)
    return np.asarray(g.senders)[em], np.asarray(g.receivers)[em], em


def aggregate_oracle(x, g, aggrs, include_self, ew, sw):
    """float64 values [N, A, F] and the function ct -> d(sum(out*ct))/dx."""
    x = np.asarray(x, np.float64)
    n, f = x.shape
    s, r, em = _valid_edges(g)
    w = np.asarray(ew, np.float64)[em]
    sw = np.asarray(sw, np.float64)
    cnt = np.bincount(r, minlength=n).astype(np.float64)[:, None]
    d = np.maximum(cnt + include_self, 1.0)
    tot = np.zeros((n, f))
    np.add.at(tot, r, x[s])
    sq = np.zeros((n, f))
    np.add.at(sq, r, x[s] ** 2)
    if include_self:
        tot, sq = tot + x, sq + x * x
    m = tot / d
    var = sq / d - m * m
    mx = np.full((n, f), -np.inf)
    np.maximum.at(mx, r, x[s])
    mn = np.full((n, f), np.inf)
    np.minimum.at(mn, r, x[s])
    has = cnt > 0
    if include_self:
        mx_out = np.where(has, np.maximum(mx, x), x)
        mn_out = np.where(has, np.minimum(mn, x), x)
    else:
        mx_out, mn_out = np.where(has, mx, 0.0), np.where(has, mn, 0.0)
    wsum = np.zeros((n, f))
    np.add.at(wsum, r, x[s] * w[:, None])
    std = np.sqrt(np.maximum(var, 0.0) + 1e-5)
    vals = {"sum": tot, "mean": m, "max": mx_out, "min": mn_out,
            "std": std, "symnorm": wsum + sw[:, None] * x}

    def grad(ct):
        ct = np.asarray(ct, np.float64)
        dx = np.zeros_like(x)
        for i, a in enumerate(aggrs):
            c = ct[:, i]
            if a in ("sum", "mean"):
                c = c if a == "sum" else c / d
                np.add.at(dx, s, c[r])
                if include_self:
                    dx += c
            elif a == "symnorm":
                np.add.at(dx, s, c[r] * w[:, None])
                dx += sw[:, None] * c
            elif a in ("max", "min"):
                ext = np.where(has, mx if a == "max" else mn, np.nan)
                if include_self:
                    # max(edge extremum, self): a tie splits the cotangent
                    # evenly (jnp.maximum/minimum), an edge-free node keeps
                    # all of it
                    beats = x > ext if a == "max" else x < ext
                    self_w = np.where(~has | beats, 1.0,
                                      np.where(x == ext, 0.5, 0.0))
                    dx += self_w * c
                else:
                    self_w = np.zeros_like(c)
                # the cotangent reaches EVERY edge achieving the extremum
                hit = x[s] == ext[r]
                np.add.at(dx, s, np.where(hit, (1.0 - self_w[r]) * c[r],
                                          0.0))
            else:  # std
                coef = np.where(var > 0, c * 0.5 / std, 0.0) * 2.0 / d
                np.add.at(dx, s, coef[r] * (x[s] - m[r]))
                if include_self:
                    dx += coef * (x - m)
        return dx

    return np.stack([vals[a] for a in aggrs], axis=1), grad


def _case(rng, width):
    g = padded_graph(rng)
    ew, sw = symnorm_weight(g.senders, g.receivers, g.num_nodes,
                            edge_mask=g.edge_mask, add_self_loops=True)
    # values on a k/8 grid: float32 sums of squares are exact, and a
    # segment's variance is 0 or >= ~1e-3, far from std's 1e-5 epsilon.
    # Continuous values put some variances near 1e-5, where float32
    # E[x^2]-E[x]^2 (the reference formula) leaves ~1e-3 of the std
    # gradient to rounding. The grid also makes max/min ties, which the
    # oracle resolves by the system's convention.
    x = rng.integers(-8, 9, (g.num_nodes, width)) / 8.0
    return g, jnp.asarray(x.astype(np.float32)), ew, sw


def _run(g, x, aggrs, include_self, ew, sw):
    return conv_aggregate(g, x, aggrs, include_self=include_self,
                          symnorm_edge_w=ew, symnorm_self_w=sw)


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("aggr_set", sorted(SETS))
def test_conv_aggregate_values(rng, aggr_set, width, include_self):
    aggrs = SETS[aggr_set]
    g, x, ew, sw = _case(rng, width)
    got = np.asarray(jax.jit(_run, static_argnums=(2, 3))(
        g, x, aggrs, include_self, ew, sw))
    ref, _ = aggregate_oracle(x, g, aggrs, include_self, ew, sw)
    assert got.shape == (g.num_nodes, len(aggrs), width)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("aggr_set", sorted(SETS))
def test_conv_aggregate_gradients(rng, aggr_set, width, include_self):
    aggrs = SETS[aggr_set]
    g, x, ew, sw = _case(rng, width)
    ct = rng.normal(size=(g.num_nodes, len(aggrs), width))
    ct = ct.astype(np.float32)

    def loss(x_):
        return jnp.sum(_run(g, x_, aggrs, include_self, ew, sw) * ct)

    got = np.asarray(jax.jit(jax.grad(loss))(x))
    _, grad = aggregate_oracle(x, g, aggrs, include_self, ew, sw)
    np.testing.assert_allclose(got, grad(ct), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# GAT / GATv2 at the arxiv head layouts, on padded graphs with masked edges
# ---------------------------------------------------------------------------

def _leaky(v):
    return np.where(v >= 0, v, 0.2 * v)


def attention_oracle(logits_e, self_logits, vals_e, self_vals, r, n):
    """Softmax over {valid in-edges} U {self} per receiver, float64."""
    H = self_logits.shape[1]
    out = np.zeros((n, H, self_vals.shape[2]))
    for i in range(n):
        sel = np.where(r == i)[0]
        lg = np.concatenate([logits_e[sel], self_logits[i][None]], axis=0)
        v = np.concatenate([vals_e[sel], self_vals[i][None]], axis=0)
        a = np.exp(lg - lg.max(axis=0, keepdims=True))
        a = a / a.sum(axis=0, keepdims=True)
        out[i] = np.einsum("kh,khc->hc", a, v)
    return out


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
@pytest.mark.parametrize("hidden,heads", [(152, 8), (112, 8), (128, 4)])
def test_attention_conv_matches_oracle(rng, kind, hidden, heads):
    g = padded_graph(rng, n=96, e=500)
    n = g.num_nodes
    C = hidden // heads
    x = rng.normal(size=(n, 24)).astype(np.float32)
    conv = (GATConv if kind == "gat" else GATv2Conv)(out_channels=C,
                                                     heads=heads)
    variables = conv.init(jax.random.key(1), g, jnp.asarray(x))
    got = np.asarray(jax.jit(conv.apply)(variables, g, jnp.asarray(x)))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     variables["params"])
    s, r, _ = _valid_edges(g)
    x64 = x.astype(np.float64)
    if kind == "gat":
        h = (x64 @ p["lin"]["kernel"]).reshape(n, heads, C)
        a_s = np.einsum("nhc,hc->nh", h, p["att_src"])
        a_d = np.einsum("nhc,hc->nh", h, p["att_dst"])
        out = attention_oracle(_leaky(a_s[s] + a_d[r]), _leaky(a_s + a_d),
                               h[s], h, r, n)
    else:
        hl = (x64 @ p["lin_l"]["kernel"] + p["lin_l"]["bias"]
              ).reshape(n, heads, C)
        hr = (x64 @ p["lin_r"]["kernel"] + p["lin_r"]["bias"]
              ).reshape(n, heads, C)

        def logits(a, b):
            return np.einsum("ehc,hc->eh", _leaky(a + b), p["att"])

        out = attention_oracle(logits(hl[s], hr[r]), logits(hl, hr),
                               hl[s], hl, r, n)
    ref = out.reshape(n, hidden) + p["bias"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gat", "gatv2"])
def test_attention_gradients_ignore_masked_edges(rng, kind):
    """Masked edges carry no gradient: the parameter gradients equal those
    on the same graph with the masked edges deleted."""
    g = padded_graph(rng, n=64, e=300, masked=0.3)
    em = np.asarray(g.edge_mask)
    s, r = np.asarray(g.senders)[em], np.asarray(g.receivers)[em]
    n = g.num_nodes
    g_clean = jax.tree.map(jnp.asarray, Graph.from_coo(
        np.zeros((n, 1), np.float32), s, r))
    x = jnp.asarray(rng.normal(size=(n, 16)).astype(np.float32))
    conv = (GATConv if kind == "gat" else GATv2Conv)(out_channels=6,
                                                     heads=4)
    variables = conv.init(jax.random.key(4), g, x)
    ct = jnp.asarray(rng.normal(size=(n, 24)).astype(np.float32))

    def grads(graph):
        return jax.grad(lambda p: jnp.sum(
            conv.apply({"params": p}, graph, x) * ct))(variables["params"])

    for a, b in zip(jax.tree.leaves(grads(g)), jax.tree.leaves(
            grads(g_clean))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
