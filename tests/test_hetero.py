"""Heterogeneous (rmag) layer parity + training tests."""

import numpy as np
import jax
import jax.numpy as jnp

from egc_tpu.data import synthetic
from egc_tpu.exp.hetero import RMagConfig
from egc_tpu.exp.runner import run_trial
from egc_tpu.graph.hetero import (
    hetero_from_numpy, rel_key,
)
from egc_tpu.nn.conv.hetero import RGCNConv, REGConv


def tiny_hetero(rng):
    nodes = {
        "a": rng.normal(size=(5, 6)).astype(np.float32),
        "b": rng.normal(size=(4, 6)).astype(np.float32),
    }
    edges = {
        rel_key("a", "to", "b"): (
            np.array([0, 1, 2, 0], np.int32), np.array([0, 0, 1, 3], np.int32)),
        rel_key("b", "back", "a"): (
            np.array([0, 1], np.int32), np.array([2, 4], np.int32)),
    }
    return nodes, edges


def test_rgcn_parity(rng):
    nodes, edges = tiny_hetero(rng)
    hg = jax.tree.map(jnp.asarray, hetero_from_numpy(nodes, edges))
    conv = RGCNConv(3)
    x_dict = {t: hg.nodes[t] for t in hg.node_types}
    params = conv.init(jax.random.key(0), hg, x_dict)["params"]
    out = conv.apply({"params": params}, hg, x_dict)

    # numpy reference: root + per-relation mean aggregation
    for t in ("a", "b"):
        k = np.asarray(params[f"root_{t}"]["kernel"])
        b = np.asarray(params[f"root_{t}"]["bias"])
        base = nodes[t] @ k + b
        n_pad = hg.num_nodes(t)
        ref = np.zeros((n_pad, 3), np.float32)
        ref[:len(base)] = base
        for key, (s, r) in edges.items():
            src, _, dst = key.split("__")
            if dst != t:
                continue
            krel = np.asarray(params[f"rel_{key}"]["kernel"])
            agg = np.zeros((n_pad, nodes[src].shape[1]), np.float32)
            cnt = np.zeros(n_pad)
            for j in range(len(s)):
                agg[r[j]] += nodes[src][s[j]]
                cnt[r[j]] += 1
            agg = agg / np.maximum(cnt, 1)[:, None]
            ref += agg @ krel
        got = np.asarray(out[t])
        valid = np.asarray(hg.node_mask[t])
        np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4,
                                   atol=1e-5)


def test_regconv_shapes_and_accumulation(rng):
    nodes, edges = tiny_hetero(rng)
    hg = jax.tree.map(jnp.asarray, hetero_from_numpy(nodes, edges))
    conv = REGConv(8, num_heads=2, num_bases=2)
    x_dict = {t: hg.nodes[t] for t in hg.node_types}
    variables = conv.init(jax.random.key(0), hg, x_dict)
    out = conv.apply(variables, hg, x_dict)
    assert out["a"].shape == (hg.num_nodes("a"), 8)
    assert out["b"].shape == (hg.num_nodes("b"), 8)
    assert np.isfinite(np.asarray(out["a"])).all()
    # grads flow through shared bases from both types
    def loss(v):
        o = conv.apply(v, hg, x_dict)
        return sum(jnp.sum(x ** 2) for x in o.values())
    g = jax.grad(loss)(variables)
    bases_g = np.asarray(g["params"]["bases"]["kernel"])
    assert np.abs(bases_g).sum() > 0


def test_rmag_trains():
    cfg = RMagConfig(hidden=32, heads=4, bases=2)
    cfg.load_hetero = lambda: synthetic.synthetic_rmag(
        num_paper=300, num_author=150, num_inst=20, num_fos=30,
        num_classes=6, num_features=32, seed=4)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.2}
    res = run_trial(cfg, hp, seed=0, max_iterations=25, patience=50,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.4, accs   # 6 classes, homophilous paper graph
