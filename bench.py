"""Benchmark: EGC-M forward+backward+Adam training step on an ogbn-arxiv
shaped graph, on one GPU.

Runs the flagship EGC-M ArxivNet (h128 H4 B4, aggregators
symnorm/max/mean — the reference's best arxiv set) full-graph training step
on a synthetic ogbn-arxiv-shaped graph (169,343 nodes, ~2.37M directed
edges) and reports the step time and edges/s. ``--grid`` runs every row of
``GRID`` (one JSON line each). Each row names the platform, device kind,
device count and the card's power limit.

It refuses to run unless JAX's first device is a GPU.

Usage: python bench.py [--small] [--steps N] [--grid]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run_config(d, *, metric, kind, hidden, aggrs=None, heads=4,
               bases=4, steps=10, num_layers=3, remat=False, card=None):
    """Time one full-graph arxiv-shaped training-step config; returns the
    row dict."""
    import jax
    import jax.numpy as jnp
    from egc_tpu.models.nets import ConvSpec, ArxivNet
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu.train.state import TrainState
    from egc_tpu.utils.device import device_fields

    num_edges = int(np.asarray(d["graph"].edge_mask).sum())
    conv = (ConvSpec(kind="egc", heads=heads, bases=bases,
                     aggrs=tuple(aggrs)) if kind == "egc"
            else ConvSpec(kind=kind, heads=heads))
    net = ArxivNet(conv=conv, hidden_dim=hidden, num_layers=num_layers,
                   dropout=0.0, residual=True, num_features=128,
                   num_classes=40, log_probs=False, remat=remat)
    variables = jax.jit(net.init, static_argnames=("train",))(
        jax.random.key(0), d["graph"], train=False)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables.get("batch_stats", {}),
                              tx=make_optimizer(1e-2, 0.0))
    y = d["y"]
    tmask = d["masks"]["train"]

    def loss_fn(params, batch_stats, graph, rng):
        out, mutated = net.apply(
            {"params": params, "batch_stats": batch_stats}, graph,
            train=True, rngs={"dropout": rng}, mutable=["batch_stats"])
        from egc_tpu.train.losses import nll_scores
        nll = nll_scores(out, y, log_probs=False)
        m = tmask.astype(out.dtype)
        return jnp.sum(nll * m) / jnp.sum(m), mutated["batch_stats"]

    @jax.jit
    def step(state, graph, rng):
        (loss, bs), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats, graph,
                                   rng)
        return state.apply_gradients(grads, new_batch_stats=bs), loss

    rng = jax.random.key(1)
    t0 = time.perf_counter()
    state, loss = step(state, d["graph"], rng)
    jax.block_until_ready(loss)
    print(f"# [{metric}] compile+first step: {time.perf_counter() - t0:.1f}s "
          f"loss={float(loss):.4f}", flush=True)
    state, loss = step(state, d["graph"], rng)
    jax.block_until_ready(loss)

    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, d["graph"], rng)
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / steps
    return {
        "metric": metric,
        "value": num_edges / dt,
        "unit": "edges/s",
        "step_time_s": dt,
        "num_edges": num_edges,
        **device_fields(card),
    }


GRID = [
    # (metric, kind, hidden, aggrs, heads)
    ("egc_m_arxiv_train_edges_per_s_per_chip", "egc", 128,
     ("symnorm", "max", "mean"), 4),
    ("egc_s_arxiv_train_edges_per_s_per_chip", "egc", 128,
     ("symnorm",), 4),
    ("egc_m6_arxiv_train_edges_per_s_per_chip", "egc", 128,
     ("sum", "mean", "max", "min", "std", "symnorm"), 4),
    ("egc_m_h136_arxiv_train_edges_per_s_per_chip", "egc", 136,
     ("symnorm", "max", "mean"), 4),
    ("gat_h152_arxiv_train_edges_per_s_per_chip", "gat", 152,
     None, 8),
]


def run_grid(d, *, steps, card=None):
    """One row per GRID entry, all on the same device dict ``d``."""
    return [run_config(d, metric=metric, kind=kind, hidden=hidden,
                       aggrs=aggrs, heads=heads, steps=steps, card=card)
            for metric, kind, hidden, aggrs, heads in GRID]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes for a quick smoke run")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize conv blocks (activation memory)")
    ap.add_argument("--aggrs", type=str, default="symnorm,max,mean")
    ap.add_argument("--grid", action="store_true",
                    help="one JSON line per GRID row")
    args = ap.parse_args(argv)

    from egc_tpu.utils.device import nvidia_smi_name_power, require_gpu

    try:
        require_gpu()
    except RuntimeError as e:
        print(f"bench.py: {e}; refusing to measure", file=sys.stderr)
        return 1
    from egc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from egc_tpu.data import synthetic
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict

    if args.small:
        n_nodes, avg_deg = 4096, 8
    else:
        n_nodes, avg_deg = 169_343, 14   # ~2.37M directed edges (arxiv-like)
    card = nvidia_smi_name_power()
    print(f"# card: {card}, nodes={n_nodes}", flush=True)
    d = full_graph_to_device_dict(synthetic.synthetic_full_graph(
        num_nodes=n_nodes, avg_degree=avg_deg, num_classes=40,
        num_features=128, seed=0))
    if args.grid:
        for row in run_grid(d, steps=args.steps, card=card):
            print(json.dumps(row), flush=True)
        return 0
    row = run_config(d, metric="egc_m_arxiv_train_edges_per_s_per_chip",
                     kind="egc", hidden=args.hidden,
                     aggrs=tuple(args.aggrs.split(",")), steps=args.steps,
                     remat=args.remat, card=card)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
