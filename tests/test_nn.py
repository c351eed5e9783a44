"""Layer-level parity tests.

- MaskedBatchNorm vs torch.nn.BatchNorm1d (independent oracle, CPU torch).
- EGC paper-math parity vs a hand-written numpy implementation of the
  equations in reference experiments/layers.py:89-140 (with materialized
  self-loops — our virtual-self-loop path must agree).
- Padding invariance: growing the pad budgets must not change valid outputs
  for ANY conv (the central masking correctness property).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from egc_tpu.graph import Graph, batch_np, pad_graph
from egc_tpu.nn import (
    MaskedBatchNorm, MLP, EGConv, GCNConv, GATConv, GATv2Conv, GINConv,
    SAGEConv, MPNNConv, PNAConv, global_mean_pool,
)


def rand_graph_dict(rng, n, f, avg_deg=3):
    e = n * avg_deg
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    keep = s != r
    return {
        "nodes": rng.normal(size=(n, f)).astype(np.float32),
        "senders": s[keep], "receivers": r[keep],
        "y": np.zeros((1,), np.float32),
    }


def to_jax(g):
    return jax.tree.map(jnp.asarray, g)


# ---------------------------------------------------------------------------
# MaskedBatchNorm vs torch
# ---------------------------------------------------------------------------

def test_masked_bn_matches_torch(rng):
    import torch

    x = rng.normal(size=(12, 5)).astype(np.float32)
    mask = np.array([True] * 9 + [False] * 3)

    bn = MaskedBatchNorm()
    variables = bn.init(jax.random.key(0), jnp.array(x), jnp.array(mask),
                        use_running_average=False)
    out, updates = bn.apply(variables, jnp.array(x), jnp.array(mask),
                            use_running_average=False,
                            mutable=["batch_stats"])

    tbn = torch.nn.BatchNorm1d(5)
    tout = tbn(torch.tensor(x[:9])).detach().numpy()
    np.testing.assert_allclose(np.asarray(out)[:9], tout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(updates["batch_stats"]["mean"],
                               tbn.running_mean.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(updates["batch_stats"]["var"],
                               tbn.running_var.numpy(), rtol=1e-4, atol=1e-6)

    # eval mode uses running stats
    vars2 = {"params": variables.get("params", {}),
             "batch_stats": updates["batch_stats"]}
    out_eval = bn.apply(vars2, jnp.array(x), jnp.array(mask),
                        use_running_average=True)
    tbn.eval()
    tout_eval = tbn(torch.tensor(x[:9])).detach().numpy()
    np.testing.assert_allclose(np.asarray(out_eval)[:9], tout_eval,
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# EGC paper-math parity (numpy oracle with materialized self loops)
# ---------------------------------------------------------------------------

def numpy_egc_paper(x, s, r, params, H, B, aggrs, weighting):
    """Direct transcription of the math in reference layers.py:89-140."""
    n = x.shape[0]
    kb = np.asarray(params["bases"]["kernel"])        # [in, B*L]
    kc = np.asarray(params["comb"]["kernel"])
    bc = np.asarray(params["comb"]["bias"])
    bias = np.asarray(params["bias"])
    O = bias.shape[0]
    L = O // H
    A = len(aggrs)

    bases = x @ kb                                    # [N, B*L]

    def agg(a, vals):
        out = np.zeros((n, vals.shape[1]), np.float32)
        if a == "symnorm":
            s2 = np.concatenate([s, np.arange(n)])
            r2 = np.concatenate([r, np.arange(n)])
            deg = np.zeros(n)
            np.add.at(deg, r2, 1.0)
            dis = 1 / np.sqrt(deg)
            w = dis[s2] * dis[r2]
            for j in range(len(s2)):
                out[r2[j]] += w[j] * vals[s2[j]]
            return out
        segs = [np.where(r == i)[0] for i in range(n)]
        for i, idx in enumerate(segs):
            if not len(idx):
                if a == "std":
                    out[i] = np.sqrt(1e-5)
                continue
            v = vals[s[idx]]
            if a == "sum":
                out[i] = v.sum(0)
            elif a == "mean":
                out[i] = v.mean(0)
            elif a == "max":
                out[i] = v.max(0)
            elif a == "min":
                out[i] = v.min(0)
            elif a == "std":
                var = (v ** 2).mean(0) - v.mean(0) ** 2
                out[i] = np.sqrt(np.maximum(var, 0) + 1e-5)
        return out

    ys = np.stack([agg(a, bases) for a in aggrs], axis=2)  # [N, B*L, A]? no:
    # agg returns [N, B*L]; reshape to [N, B, L]
    ys = np.stack([agg(a, bases).reshape(n, B, L) for a in aggrs], axis=2)
    # ys: [N, B, A, L]
    w = (x @ kc + bc)                                 # [N, H*B*A]
    if weighting == "softmax":
        w = w.reshape(n, H, B * A)
        w = np.exp(w - w.max(-1, keepdims=True))
        w = w / w.sum(-1, keepdims=True)
    elif weighting == "sigmoid":
        w = 1.0 / (1.0 + np.exp(-w))
    elif weighting == "hardtanh":
        w = np.clip(w, -1.0, 1.0)
    w = w.reshape(n, H, B, A)
    z = np.einsum("nhba,nbal->nhl", w, ys).reshape(n, O)
    return z + bias


@pytest.mark.parametrize("weighting,aggrs", [
    ("softmax", ("symnorm",)),                       # EGC-S
    ("none", ("sum", "std", "max")),                 # EGC-M (zinc best)
    ("none", ("symnorm", "max", "mean")),            # EGC-M (arxiv best)
    ("sigmoid", ("mean", "min")),
])
def test_egc_paper_parity(rng, weighting, aggrs):
    n, f, H, B, O = 13, 8, 4, 2, 8
    gd = rand_graph_dict(rng, n, f)
    x, s, r = gd["nodes"], gd["senders"], gd["receivers"]
    g = to_jax(Graph.from_coo(x, s, r))

    conv = EGConv(out_channels=O, num_heads=H, num_bases=B, aggrs=aggrs,
                  weighting=weighting, self_loop_mode="paper")
    params = conv.init(jax.random.key(1), g, g.nodes)["params"]
    out = conv.apply({"params": params}, g, g.nodes)

    ref = numpy_egc_paper(x, s, r, params, H, B,
                          [a for a in aggrs], weighting)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)


def test_gcn_parity(rng):
    n, f, O = 11, 6, 4
    gd = rand_graph_dict(rng, n, f)
    x, s, r = gd["nodes"], gd["senders"], gd["receivers"]
    g = to_jax(Graph.from_coo(x, s, r))
    conv = GCNConv(O)
    params = conv.init(jax.random.key(0), g, g.nodes)["params"]
    out = conv.apply({"params": params}, g, g.nodes)

    k = np.asarray(params["lin"]["kernel"])
    h = x @ k
    s2 = np.concatenate([s, np.arange(n)])
    r2 = np.concatenate([r, np.arange(n)])
    deg = np.zeros(n); np.add.at(deg, r2, 1.0)
    dis = 1 / np.sqrt(deg)
    ref = np.zeros((n, O), np.float32)
    for j in range(len(s2)):
        ref[r2[j]] += dis[s2[j]] * dis[r2[j]] * h[s2[j]]
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)


def test_gat_self_loop_parity(rng):
    """Virtual-self-loop attention == numpy softmax over edges + self."""
    n, f, H, C = 9, 5, 2, 3
    gd = rand_graph_dict(rng, n, f)
    x, s, r = gd["nodes"], gd["senders"], gd["receivers"]
    g = to_jax(Graph.from_coo(x, s, r))
    conv = GATConv(out_channels=C, heads=H)
    params = conv.init(jax.random.key(0), g, g.nodes)["params"]
    out = conv.apply({"params": params}, g, g.nodes)

    k = np.asarray(params["lin"]["kernel"])
    asrc = np.asarray(params["att_src"]); adst = np.asarray(params["att_dst"])
    h = (x @ k).reshape(n, H, C)
    al_src = (h * asrc).sum(-1)   # [N, H]
    al_dst = (h * adst).sum(-1)
    s2 = np.concatenate([s, np.arange(n)])
    r2 = np.concatenate([r, np.arange(n)])
    logits = al_src[s2] + al_dst[r2]
    logits = np.where(logits > 0, logits, 0.2 * logits)  # leaky relu
    ref = np.zeros((n, H, C), np.float32)
    for i in range(n):
        idx = np.where(r2 == i)[0]
        lg = logits[idx]
        p = np.exp(lg - lg.max(0, keepdims=True))
        p = p / p.sum(0, keepdims=True)
        ref[i] = (p[:, :, None] * h[s2[idx]]).sum(0)
    ref = ref.reshape(n, H * C) + np.asarray(params["bias"])
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)


def test_gat_no_self_loops_oracle(rng):
    """add_self_loops=False: softmax over real in-edges only; empty
    receivers produce exact zeros (PyG semantics)."""
    n, f, H, C = 11, 4, 2, 3
    gd = rand_graph_dict(rng, n, f)
    x, s, r = gd["nodes"], gd["senders"], gd["receivers"]
    g = to_jax(Graph.from_coo(x, s, r))
    conv = GATConv(out_channels=C, heads=H, add_self_loops=False,
                   use_bias=False)
    params = conv.init(jax.random.key(0), g, g.nodes)["params"]
    out = np.asarray(conv.apply({"params": params}, g, g.nodes))

    k = np.asarray(params["lin"]["kernel"])
    h = (x @ k).reshape(n, H, C)
    al_src = (h * np.asarray(params["att_src"])).sum(-1)
    al_dst = (h * np.asarray(params["att_dst"])).sum(-1)
    logits = al_src[s] + al_dst[r]
    logits = np.where(logits > 0, logits, 0.2 * logits)
    ref = np.zeros((n, H, C), np.float32)
    for i in range(n):
        idx = np.where(r == i)[0]
        if len(idx) == 0:
            continue
        lg = logits[idx]
        p = np.exp(lg - lg.max(0, keepdims=True))
        p = p / p.sum(0, keepdims=True)
        ref[i] = (p[:, :, None] * h[s[idx]]).sum(0)
    np.testing.assert_allclose(out, ref.reshape(n, H * C),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("share", [False, True])
def test_gatv2_oracle(rng, share):
    """GATv2Conv vs a from-scratch numpy oracle: share_weights both ways,
    per-Dense biases, virtual self-loop, trailing output bias (PyG
    GATv2Conv semantics, reference zinc/models.py:81-89)."""
    n, f, H, C = 10, 5, 2, 4
    gd = rand_graph_dict(rng, n, f)
    x, s, r = gd["nodes"], gd["senders"], gd["receivers"]
    g = to_jax(Graph.from_coo(x, s, r))
    conv = GATv2Conv(out_channels=C, heads=H, share_weights=share)
    params = conv.init(jax.random.key(0), g, g.nodes)["params"]
    out = np.asarray(conv.apply({"params": params}, g, g.nodes))

    kl = np.asarray(params["lin_l"]["kernel"])
    bl = np.asarray(params["lin_l"]["bias"])
    hl = (x @ kl + bl).reshape(n, H, C)
    if share:
        assert "lin_r" not in params
        hr = hl
    else:
        kr = np.asarray(params["lin_r"]["kernel"])
        br = np.asarray(params["lin_r"]["bias"])
        hr = (x @ kr + br).reshape(n, H, C)
    att = np.asarray(params["att"])
    s2 = np.concatenate([s, np.arange(n)])
    r2 = np.concatenate([r, np.arange(n)])
    z = hl[s2] + hr[r2]
    z = np.where(z > 0, z, 0.2 * z)
    logits = (z * att).sum(-1)                    # [E+N, H]
    ref = np.zeros((n, H, C), np.float32)
    for i in range(n):
        idx = np.where(r2 == i)[0]
        lg = logits[idx]
        p = np.exp(lg - lg.max(0, keepdims=True))
        p = p / p.sum(0, keepdims=True)
        ref[i] = (p[:, :, None] * hl[s2[idx]]).sum(0)
    ref = ref.reshape(n, H * C) + np.asarray(params["bias"])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_attention_dropout_gate(rng):
    """Attention dropout samples per-edge alphas only while TRAINING with
    dropout > 0: eval is deterministic, training draws from the dropout
    key (same key -> same output, other key -> other output) and differs
    from eval."""
    n, f = 12, 4
    gd = rand_graph_dict(rng, n, f)
    g = to_jax(Graph.from_coo(gd["nodes"], gd["senders"], gd["receivers"]))
    conv = GATConv(out_channels=3, heads=2, dropout=0.5)
    params = conv.init(jax.random.key(0), g, g.nodes)["params"]

    def train(seed):
        return np.asarray(conv.apply({"params": params}, g, g.nodes,
                                     train=True,
                                     rngs={"dropout": jax.random.key(seed)}))

    out_eval = np.asarray(conv.apply({"params": params}, g, g.nodes,
                                     train=False))
    np.testing.assert_array_equal(
        out_eval, np.asarray(conv.apply({"params": params}, g, g.nodes)))
    np.testing.assert_array_equal(train(1), train(1))
    assert not np.allclose(train(1), train(2))
    assert not np.allclose(train(1), out_eval)


# ---------------------------------------------------------------------------
# Padding invariance for every conv
# ---------------------------------------------------------------------------

def _conv_factories():
    return {
        "egc_paper": lambda: EGConv(8, num_heads=4, num_bases=2,
                                    aggrs=("symnorm", "std", "max"),
                                    self_loop_mode="paper"),
        "egc_all": lambda: EGConv(8, num_heads=4, num_bases=2,
                                  aggrs=("sum", "mean", "min"),
                                  self_loop_mode="all"),
        "egc_softmax": lambda: EGConv(8, num_heads=2, num_bases=2,
                                      aggrs=("symnorm",), weighting="softmax"),
        "gcn": lambda: GCNConv(8),
        "gat": lambda: GATConv(4, heads=2),
        "gatv2": lambda: GATv2Conv(4, heads=2),
        "sage": lambda: SAGEConv(8),
        "gin": lambda: GINConv(mlp=MLP([8, 8])),
        "mpnn_sum": lambda: MPNNConv(8, aggr="sum"),
        "mpnn_max": lambda: MPNNConv(8, aggr="max"),
        "pna": lambda: PNAConv(8, avg_log_deg=1.1),
    }


@pytest.mark.parametrize("name", sorted(_conv_factories()))
def test_padding_invariance(rng, name):
    conv = _conv_factories()[name]()
    g1_dict = rand_graph_dict(rng, 10, 8)
    g2_dict = rand_graph_dict(rng, 7, 8)
    small, _ = batch_np([g1_dict, g2_dict], num_nodes=20, num_edges=64,
                        num_graphs=3)
    big = pad_graph(small, num_nodes=40, num_edges=128, num_graphs=6)
    small, big = to_jax(small), to_jax(big)

    kwargs = {}
    if name == "gin":
        kwargs = {"train": False}
    variables = conv.init(jax.random.key(0), small, small.nodes, **kwargs)
    out_s = conv.apply(variables, small, small.nodes, **kwargs)
    out_b = conv.apply(variables, big, big.nodes, **kwargs)
    valid = np.asarray(small.node_mask)
    np.testing.assert_allclose(np.asarray(out_b)[:20][valid],
                               np.asarray(out_s)[valid],
                               rtol=1e-4, atol=1e-5, err_msg=name)


def test_pool_padding_invariance(rng):
    gd = rand_graph_dict(rng, 10, 4)
    small, _ = batch_np([gd], num_nodes=12, num_edges=40, num_graphs=2)
    big = pad_graph(small, num_nodes=30, num_edges=80, num_graphs=5)
    small, big = to_jax(small), to_jax(big)
    p_s = global_mean_pool(small.nodes, small.graph_ids, small.num_graphs,
                           small.node_mask)
    p_b = global_mean_pool(big.nodes, big.graph_ids, big.num_graphs,
                           big.node_mask)
    np.testing.assert_allclose(np.asarray(p_b)[0], np.asarray(p_s)[0],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# PNA parity vs an edge-level numpy oracle (reference PyG PNAConv semantics:
# per-tower pre-Linear on [x_i || x_j] per EDGE, aggregate, degree scalers,
# per-tower post-Linear — reference experiments/arxiv/norm_models.py:174-182)
# ---------------------------------------------------------------------------

def numpy_pna(x, s, r, params, T, avg_log_deg, aggregators, scalers,
              divide_input):
    n = x.shape[0]
    if divide_input:
        f_in = x.shape[1] // T
        xt = x.reshape(n, T, f_in).astype(np.float64)
    else:
        f_in = x.shape[1]
        xt = np.broadcast_to(x[:, None, :], (n, T, f_in)).astype(np.float64)
    wpre = np.asarray(params["pre_kernel"], np.float64)
    bpre = np.asarray(params["pre_bias"], np.float64)
    h = np.concatenate([xt[r], xt[s]], axis=-1)        # [E, T, 2 f_in]
    msg = np.einsum("etf,tfo->eto", h, wpre) + bpre    # [E, T, f_in]

    aggs = []
    for a in aggregators:
        out = np.zeros((n, T, f_in))
        for i in range(n):
            sel = msg[r == i]
            if a == "mean":
                out[i] = sel.mean(0) if len(sel) else 0.0
            elif a == "min":
                out[i] = sel.min(0) if len(sel) else 0.0
            elif a == "max":
                out[i] = sel.max(0) if len(sel) else 0.0
            elif a in ("sum", "add"):
                out[i] = sel.sum(0)
            elif a in ("var", "std"):
                v = ((sel ** 2).mean(0) - sel.mean(0) ** 2) if len(sel) else 0.0
                v = np.maximum(v, 0.0)
                out[i] = np.sqrt(v + 1e-5) if a == "std" else v
        aggs.append(out)
    agg = np.concatenate(aggs, axis=-1)

    deg = np.zeros(n)
    np.add.at(deg, r, 1.0)
    log_deg = np.log(np.maximum(deg, 1.0) + 1.0)[:, None, None]
    scaled = []
    for sc in scalers:
        if sc == "identity":
            scaled.append(agg)
        elif sc == "amplification":
            scaled.append(agg * (log_deg / avg_log_deg))
        elif sc == "attenuation":
            scaled.append(agg * (avg_log_deg / log_deg))
    agg = np.concatenate(scaled, axis=-1)

    post_in = np.concatenate([xt, agg], axis=-1)
    wpost = np.asarray(params["post_kernel"], np.float64)
    bpost = np.asarray(params["post_bias"], np.float64)
    out = np.einsum("ntf,tfo->nto", post_in, wpost) + bpost
    out = out.reshape(n, -1)
    k = np.asarray(params["lin"]["kernel"], np.float64)
    b = np.asarray(params["lin"]["bias"], np.float64)
    return out @ k + b


@pytest.mark.parametrize("divide_input", [True, False])
@pytest.mark.parametrize("aggrs", [("mean", "min", "max", "std"),
                                   ("sum", "var", "mean")])
def test_pna_oracle(rng, divide_input, aggrs):
    n, f, O, T = 12, 8, 8, 2
    gd = rand_graph_dict(rng, n, f)
    s, r = gd["senders"], gd["receivers"]
    keep = r != n - 1                 # force an isolated receiver
    s, r = s[keep], r[keep]
    x = gd["nodes"]
    g = to_jax(Graph.from_coo(x, s, r))

    conv = PNAConv(O, avg_log_deg=1.3, towers=T, aggregators=aggrs,
                   divide_input=divide_input)
    params = conv.init(jax.random.key(2), g, g.nodes)["params"]
    out = conv.apply({"params": params}, g, g.nodes)

    ref = numpy_pna(x, s, r, params, T, 1.3, aggrs,
                    ("identity", "amplification", "attenuation"),
                    divide_input)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-5)
