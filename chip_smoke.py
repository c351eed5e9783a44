"""Smoke run of the training path on the GPU, end to end, in one process.

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --four-gpus  # four GPUs: phase 1 and phase 6 only

Phases (one ``[phase]`` line each, or more):

1. device: platform, device kind and count, jax/jaxlib versions, the card's
   name and power limit (``nvidia-smi``), ``XLA_FLAGS`` and the compile
   cache directory;
2. trainer: EGC-M h136 H4 B4 (symnorm, max, mean), 3 layers, on an
   ogbn-arxiv-shaped synthetic graph, through ``exp.runner.run_trial`` for
   5 iterations: compile time, one warm step time (not a benchmark), the
   step's ``memory_analysis()``, peak device memory, the loss of each
   iteration (must be finite);
3. CLI: ``main.main([... --check ...])`` in-process;
4. attention: one training step each of GAT h152 H8 and GATv2 h112 H8 at
   arxiv scale, with their memory;
5. reference: ``conv_aggregate`` for six aggregators at F=136 against a
   float64 host reference on sampled receivers; one EGConv h136 layer at
   default and at ``highest`` matmul precision (their difference shows
   whether float32 matmuls ran in TF32), and the ``highest`` run against a
   float64 reference of the layer;
6. ``--four-gpus``: the partitioned arxiv step (``PartitionedArxivConfig``,
   halo ``all_to_all`` over the 4-device ``graph`` mesh) and the
   data-parallel zinc step (``make_dp_train_step``), each against the same
   step on one device.

Any failure raises: the script then exits non-zero and prints no result
line. The last line is ``{"ok": true, "device": {...}}``. It refuses to
run unless JAX's first device is a GPU. The phase functions take their
sizes as arguments so that the tests can run them small on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# ogbn-arxiv shape (169,343 nodes, ~2.37M directed edges) and the
# reference's tuned EGC-M arxiv row (scripts/train_main_table.sh)
ARXIV = dict(num_nodes=169_343, avg_degree=14, num_classes=40,
             num_features=128)
EGC_M = dict(hidden=136, heads=4, bases=4, aggrs=("symnorm", "max", "mean"))
# attention rows: GAT h152 H8 and GATv2 h112 (H8 default)
ATTENTION = (("gat", 152, 8), ("gatv2", 112, 8))
REF_AGGRS = ("symnorm", "max", "mean", "sum", "min", "std")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _mib(n) -> str:
    return "n/a" if n is None else f"{n / 2**20:.1f} MiB"


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    return (f"memory_analysis: arguments {_mib(m.argument_size_in_bytes)}, "
            f"outputs {_mib(m.output_size_in_bytes)}, "
            f"temp {_mib(m.temp_size_in_bytes)}, "
            f"aliased {_mib(m.alias_size_in_bytes)}, "
            f"code {_mib(m.generated_code_size_in_bytes)}")


def peak_bytes():
    """``memory_stats()["peak_bytes_in_use"]`` of the first device (None
    where the backend keeps no statistics, as on the CPU). A process-wide
    high-water mark."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree_rel_l2(a, b) -> float:
    import jax

    la = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(b)]
    return rel_l2(np.concatenate(la), np.concatenate(lb))


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import jax
    import jaxlib

    from egc_tpu.utils.compile_cache import ENV_VAR, DEFAULT_DIR
    from egc_tpu.utils.device import device_fields, nvidia_smi_name_power

    card = nvidia_smi_name_power()
    fields = device_fields(card)
    log("device", f"platform={fields['platform']} "
                  f"kind={fields['device_kind']} "
                  f"count={fields['device_count']} jax={jax.__version__} "
                  f"jaxlib={jaxlib.__version__}")
    log("device", f"nvidia-smi name, power.limit: {card or 'not available'}")
    log("device", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    cache = jax.config.jax_compilation_cache_dir or \
        os.environ.get(ENV_VAR) or "off"
    log("device", f"compile cache: {cache} (default {DEFAULT_DIR})")
    return fields


# ---------------------------------------------------------------------------
# 2. trainer
# ---------------------------------------------------------------------------

def arxiv_graph(num_nodes=ARXIV["num_nodes"],
                avg_degree=ARXIV["avg_degree"], seed=0) -> dict:
    from egc_tpu.data import synthetic

    return synthetic.synthetic_full_graph(
        num_nodes=num_nodes, avg_degree=avg_degree,
        num_classes=ARXIV["num_classes"],
        num_features=ARXIV["num_features"], seed=seed)


def _arxiv_config(kind, hidden, *, heads, bases=4, aggrs=None, data):
    """ArxivConfig whose dataset is the given device dict."""
    from egc_tpu.exp.fullgraph import ArxivConfig

    cfg = ArxivConfig(kind, hidden, heads=heads, bases=bases, aggrs=aggrs,
                      gat_version=2 if kind == "gatv2" else 1)
    cfg.data = lambda hparams: data
    return cfg


def compile_and_step(phase, cfg, hparams, data, *, warm_steps=1) -> dict:
    """AOT-compile the config's own jitted train step, print its compile
    time and memory, run it (warm), and return the numbers."""
    import jax

    model = cfg.model(hparams)
    state = cfg.init_state(model, hparams, data, 0)
    step, _ = cfg._steps(model)
    args = (state, data["graph"], (data["y"], data["masks"]["train"]),
            jax.random.key(0))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    log(phase, f"compile {compile_s:.2f} s; {_memory_line(compiled)}")
    state, loss = compiled(*args)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for i in range(warm_steps):
        state, loss = compiled(state, *args[1:3], jax.random.key(i + 1))
    jax.block_until_ready(loss)
    step_s = (time.perf_counter() - t0) / warm_steps
    loss = float(loss)
    log(phase, f"warm step {step_s * 1e3:.2f} ms (host clock around "
               f"block_until_ready, {warm_steps} step(s); not a benchmark); "
               f"loss {loss:.5f}; peak device memory "
               f"{_mib(peak_bytes())}")
    if not np.isfinite(loss):
        raise FloatingPointError(f"{phase}: loss {loss}")
    return {"compile_s": compile_s, "step_s": step_s, "loss": loss}


def phase_trainer(raw, *, iterations=5, hidden=EGC_M["hidden"],
                  heads=EGC_M["heads"], bases=EGC_M["bases"],
                  aggrs=EGC_M["aggrs"]) -> dict:
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict
    from egc_tpu.exp.runner import run_trial

    t0 = time.perf_counter()
    data = full_graph_to_device_dict(raw)
    n_edges = int(np.asarray(data["graph"].edge_mask).sum())
    log("trainer", f"graph: {raw['x'].shape[0]} nodes, {n_edges} edges, "
                   f"host set-up {time.perf_counter() - t0:.1f} s")
    cfg = _arxiv_config("egc", hidden, heads=heads, bases=bases,
                        aggrs=aggrs, data=data)
    hp = cfg.default_hparams()
    out = compile_and_step("trainer", cfg, hp, data, warm_steps=3)
    res = run_trial(cfg, hp, max_iterations=iterations,
                    patience=iterations + 1, verbose=False)
    losses = [h["train_loss"] for h in res["history"]]
    for h in res["history"]:
        log("trainer", f"iteration {h['iteration']}: train_loss "
                       f"{h['train_loss']:.5f} val_acc {h['val_acc']:.4f}")
    if len(losses) != iterations or not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"trainer: losses {losses}")
    log("trainer", f"{iterations} iterations ok; test {res['test']}; "
                   f"peak device memory {_mib(peak_bytes())}")
    return {**out, "losses": losses, "data": data}


# ---------------------------------------------------------------------------
# 3. CLI
# ---------------------------------------------------------------------------

def phase_cli(exp_dir, *, check_epochs=2, hidden=EGC_M["hidden"]) -> None:
    import main as cli

    argv = [str(exp_dir), "egc", "arxiv", "--check", "--check-epochs",
            str(check_epochs), "--hidden", str(hidden), "--egc-num-heads",
            "4", "--egc-num-bases", "4", "--aggrs", "symadd,max,mean"]
    log("cli", "main.py " + " ".join(argv))
    cli.main(argv)
    log("cli", "ok")


# ---------------------------------------------------------------------------
# 4. attention
# ---------------------------------------------------------------------------

def phase_attention(data, rows=ATTENTION) -> dict:
    out = {}
    for kind, hidden, heads in rows:
        name = f"attention {kind} h{hidden} H{heads}"
        cfg = _arxiv_config(kind, hidden, heads=heads, data=data)
        out[kind] = compile_and_step(name, cfg, cfg.default_hparams(), data)
    return out


# ---------------------------------------------------------------------------
# 5. plain reference at real width
# ---------------------------------------------------------------------------

def _host_graph(g):
    import jax

    g = jax.device_get(g)
    em = np.asarray(g.edge_mask)
    return (np.asarray(g.senders)[em], np.asarray(g.receivers)[em],
            np.asarray(g.edge_weight, np.float64)[em],
            np.asarray(g.self_weight, np.float64))


def reference_aggregate(x64, senders, receivers, edge_w, self_w, rows,
                        aggrs):
    """float64 numpy reference of ``multi_aggregate`` (include_self=False,
    symnorm with its self-loop weight) at the receivers ``rows``:
    returns [len(rows), A, F]."""
    rows = np.asarray(rows)
    order = np.argsort(rows)
    pos = np.full(x64.shape[0], -1)
    pos[rows[order]] = order
    sel = pos[receivers] >= 0
    s, r, w = senders[sel], pos[receivers[sel]], edge_w[sel]
    k, f = len(rows), x64.shape[1]
    xs = x64[s]
    cnt = np.bincount(r, minlength=k).astype(np.float64)[:, None]
    tot = np.zeros((k, f))
    np.add.at(tot, r, xs)
    sq = np.zeros((k, f))
    np.add.at(sq, r, xs * xs)
    wsum = np.zeros((k, f))
    np.add.at(wsum, r, xs * w[:, None])
    mx = np.full((k, f), -np.inf)
    np.maximum.at(mx, r, xs)
    mn = np.full((k, f), np.inf)
    np.minimum.at(mn, r, xs)
    has = cnt > 0
    d = np.maximum(cnt, 1.0)
    var = sq / d - (tot / d) ** 2
    table = {
        "sum": tot, "mean": tot / d,
        "max": np.where(has, mx, 0.0), "min": np.where(has, mn, 0.0),
        "std": np.sqrt(np.maximum(var, 0.0) + 1e-5),
        "symnorm": wsum + self_w[rows][:, None] * x64[rows],
    }
    return np.stack([table[a] for a in aggrs], axis=1)


def reference_egconv(params, x64, host_graph, rows, *, heads, bases,
                     aggrs):
    """float64 reference of one EGConv layer (paper self-loop mode, no
    weighting) at the receivers ``rows``: returns [len(rows), O]."""
    s, r, w, sw = host_graph
    p = {k: np.asarray(v, np.float64) for k, v in (
        ("wb", params["bases"]["kernel"]), ("wc", params["comb"]["kernel"]),
        ("bc", params["comb"]["bias"]), ("b", params["bias"]))}
    bases_all = x64 @ p["wb"]
    y = reference_aggregate(bases_all, s, r, w, sw, rows, aggrs)
    n, a = len(rows), len(aggrs)
    out = p["b"].shape[0]
    L = out // heads
    y = y.reshape(n, a, bases, L)
    comb = (x64[rows] @ p["wc"] + p["bc"]).reshape(n, heads, bases, a)
    return np.einsum("nhba,nabl->nhl", comb, y).reshape(n, out) + p["b"]


def phase_reference(data, *, hidden=EGC_M["hidden"], samples=4096,
                    seed=0, atol=1e-4, rtol=1e-5, layer_tol=1e-5) -> dict:
    import jax
    import jax.numpy as jnp

    from egc_tpu.nn import EGConv
    from egc_tpu.ops.dispatch import conv_aggregate

    g = data["graph"]
    n_real = int(np.asarray(g.node_mask).sum())
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n_real, size=min(samples, n_real),
                              replace=False))
    x = np.zeros((g.num_nodes, hidden), np.float32)
    # |x| <= 1 keeps float32 E[x^2] - E[x]^2 within atol of the float64 std
    x[:n_real] = rng.uniform(-1.0, 1.0, (n_real, hidden))
    hg = _host_graph(g)
    x64 = x.astype(np.float64)

    agg = jax.jit(lambda g_, x_: conv_aggregate(
        g_, x_, REF_AGGRS, symnorm_edge_w=g_.edge_weight,
        symnorm_self_w=g_.self_weight))
    got = np.asarray(agg(g, jnp.asarray(x)))[rows]
    ref = reference_aggregate(x64, *hg, rows, REF_AGGRS)
    for i, a in enumerate(REF_AGGRS):
        err = np.abs(got[:, i] - ref[:, i])
        bad = err > atol + rtol * np.abs(ref[:, i])
        log("reference", f"aggregate {a} F={hidden}: max abs err "
                         f"{err.max():.3e} on {len(rows)} receivers")
        if bad.any():
            raise AssertionError(
                f"aggregate {a}: {int(bad.sum())} values beyond atol {atol} "
                f"rtol {rtol}")

    layer = EGConv(hidden, num_heads=EGC_M["heads"],
                   num_bases=EGC_M["bases"], aggrs=EGC_M["aggrs"])
    xj = jnp.asarray(x)
    params = jax.jit(layer.init)(jax.random.key(seed), g, xj)["params"]
    fwd_default = jax.jit(lambda p, g_, x_: layer.apply({"params": p}, g_,
                                                        x_))
    out_default = np.asarray(fwd_default(params, g, xj))
    with jax.default_matmul_precision("highest"):
        fwd_highest = jax.jit(lambda p, g_, x_: layer.apply(
            {"params": p}, g_, x_))
        out_highest = np.asarray(fwd_highest(params, g, xj))
    tf32_diff = rel_l2(out_default[:n_real], out_highest[:n_real])
    # float32 rounding alone separates the two by ~1e-7
    log("reference", f"EGConv h{hidden} layer: default vs highest matmul "
                     f"precision rel L2 {tf32_diff:.3e} -> "
                     + ("default float32 matmuls ran at reduced (TF32) "
                        "precision" if tf32_diff > 1e-5 else
                        "default float32 matmuls ran in float32"))
    ref_layer = reference_egconv(jax.device_get(params), x64, hg, rows,
                                 heads=EGC_M["heads"],
                                 bases=EGC_M["bases"], aggrs=EGC_M["aggrs"])
    err_highest = rel_l2(out_highest[rows], ref_layer)
    err_default = rel_l2(out_default[rows], ref_layer)
    log("reference", f"EGConv h{hidden} layer vs float64: highest rel L2 "
                     f"{err_highest:.3e} (limit {layer_tol:g}), default "
                     f"rel L2 {err_default:.3e}")
    if not err_highest <= layer_tol:
        raise AssertionError(f"highest-precision layer rel L2 "
                             f"{err_highest} > {layer_tol}")
    return {"tf32_rel_l2": tf32_diff, "highest_rel_l2": err_highest,
            "default_rel_l2": err_default}


# ---------------------------------------------------------------------------
# 6. four devices
# ---------------------------------------------------------------------------

def _perturbed(params, seed=7, scale=0.05):
    """params + U(-scale, scale): no parameter is exactly 0, so weight
    decay, not rounding noise, sets the sign of Adam's first update where
    BatchNorm makes the true gradient 0 (the biases feeding a norm)."""
    import jax

    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree.unflatten(treedef, [
        p + jax.random.uniform(k, p.shape, p.dtype, -scale, scale)
        for p, k in zip(leaves, keys)])


def _shard_devices(arr) -> str:
    return ", ".join(f"{s.index[0].start or 0}->{s.device}"
                     for s in arr.addressable_shards)


def _at_highest_precision(fn):
    """Run ``fn`` with float32 matmuls at full float32 precision. At the
    default precision the H100 multiplies in TF32, which turns the 1e-7
    differences that summation order leaves between two layouts into
    1e-4 differences (PERF.md); a comparison of layouts needs float32."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        import jax

        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@_at_highest_precision
def phase_partitioned(raw, devices, *, hidden=EGC_M["hidden"],
                      tol=1e-4) -> dict:
    """The PartitionedArxivConfig step on a len(devices) 'graph' mesh vs
    the same step on devices[0] alone (same data, params and precision:
    ``highest``)."""
    import jax

    from egc_tpu.exp.fullgraph import (PartitionedArxivConfig,
                                       full_graph_to_device_dict)
    from egc_tpu.models.nets import ArxivNet
    from egc_tpu.parallel import make_partitioned_eval_step
    from egc_tpu.train.loop import make_eval_step, make_train_step
    from egc_tpu.train.state import TrainState

    parts = len(devices)
    hp = {"lr": 0.01, "wd": 5e-4, "dropout": 0.0}
    cfg = PartitionedArxivConfig("egc", hidden, heads=EGC_M["heads"],
                                 bases=EGC_M["bases"], aggrs=EGC_M["aggrs"],
                                 partitions=parts)
    cfg.load_full_graph = lambda: raw
    data = cfg.data(hp)
    plan = data["plan"]
    model = cfg.model(hp)
    state0 = cfg.init_state(model, hp, data, 0)
    state = TrainState.create(params=_perturbed(state0.params),
                              batch_stats=state0.batch_stats,
                              tx=cfg.optimizer(hp))
    log("partitioned", f"{parts} partitions on mesh devices "
                       f"{[str(d) for d in cfg._mesh.devices.ravel()]}; "
                       f"n_local {plan.n_local}, n_ext {plan.n_ext}")
    log("partitioned", "graph.senders shards (row -> device): "
                       + _shard_devices(data["graph"].senders))
    n = raw["x"].shape[0]
    logp = make_partitioned_eval_step(cfg._model_obj, cfg._mesh)(
        state, data["graph"], data["send_idx"])
    got_logits = plan.gather_nodes(np.asarray(logp)[:, :plan.n_local], n)
    new_state, _ = cfg.train(model, state, data, jax.random.key(0), 0)
    got_params = jax.device_get(new_state.params)

    # the same step on one device
    dev0 = devices[0]
    full = full_graph_to_device_dict(raw)
    single = TrainState.create(
        params=jax.device_put(state.params, dev0),
        batch_stats=jax.device_put(state.batch_stats, dev0),
        tx=cfg.optimizer(hp))
    net = ArxivNet(conv=cfg.conv_spec(), hidden_dim=hidden,
                   num_layers=cfg.num_layers, dropout=0.0, residual=True,
                   num_features=raw["x"].shape[1],
                   num_classes=raw["num_classes"])
    ref_logits = np.asarray(make_eval_step(net)(single, full["graph"]))[:n]
    step = make_train_step(net, cfg.loss_fn)
    ref_state, _ = step(single, full["graph"],
                        (full["y"], full["masks"]["train"]),
                        jax.random.key(0))
    fwd_err = rel_l2(got_logits, ref_logits)
    par_err = _tree_rel_l2(got_params, jax.device_get(ref_state.params))
    log("partitioned", f"forward log-probs rel L2 {fwd_err:.3e}; params "
                       f"after one Adam step rel L2 {par_err:.3e} "
                       f"(limit {tol:g})")
    if not (fwd_err <= tol and par_err <= tol):
        raise AssertionError(f"partitioned vs single device: forward "
                             f"{fwd_err}, params {par_err}")
    return {"forward_rel_l2": fwd_err, "params_rel_l2": par_err}


@_at_highest_precision
def phase_data_parallel(devices, *, graphs_per_device=16, hidden=64,
                        tol=1e-4) -> dict:
    """make_dp_train_step over len(devices) devices on zinc-shaped batches
    vs the single-device step on the concatenated big batch (matmul
    precision ``highest``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from egc_tpu.data import synthetic
    from egc_tpu.graph.structure import batch_np
    from egc_tpu.models.nets import ConvSpec, ZincNet
    from egc_tpu.parallel import (make_dp_train_step, make_mesh,
                                  stack_microbatches)
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu.train.state import TrainState

    nd = len(devices)
    k = graphs_per_device
    graphs = synthetic.synthetic_zinc(num_graphs=4 * nd * k)["train"][:nd * k]
    micro = [batch_np(graphs[d * k:(d + 1) * k], num_nodes=48 * k,
                      num_edges=128 * k, num_graphs=k + 1)
             for d in range(nd)]
    big_g, big_y = batch_np(graphs, num_nodes=nd * 48 * k,
                            num_edges=nd * 128 * k, num_graphs=nd * (k + 1))
    conv = ConvSpec(kind="egc", heads=4, bases=4,
                    aggrs=("symnorm", "max", "mean"))

    def loss_sum(out, y, graph):
        err = jnp.abs(out.reshape(-1) - y.reshape(-1).astype(out.dtype))
        m = graph.graph_mask.astype(out.dtype)
        return jnp.sum(err * m), jnp.sum(m)

    net_dp = ZincNet(conv=conv, hidden_dim=hidden, num_layers=4,
                     bn_axis="data")
    net_1d = ZincNet(conv=conv, hidden_dim=hidden, num_layers=4)
    dev0 = devices[0]
    big_g = jax.device_put(jax.tree.map(jnp.asarray, big_g), dev0)
    big_y = jax.device_put(jnp.asarray(big_y), dev0)
    variables = jax.jit(net_1d.init, static_argnames=("train",))(
        jax.random.key(2), big_g, train=False)
    tx = make_optimizer(1e-3, 5e-4)
    state = TrainState.create(params=_perturbed(variables["params"]),
                              batch_stats=variables["batch_stats"], tx=tx)

    @jax.jit
    def single_step(state, graph, y):
        def loss_fn(params):
            out, mutated = net_1d.apply(
                {"params": params, "batch_stats": state.batch_stats},
                graph, train=True, mutable=["batch_stats"])
            s, c = loss_sum(out, y, graph)
            return s / c, mutated["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), loss

    ref_state, ref_loss = single_step(state, big_g, big_y)
    mesh = make_mesh({"data": nd}, devices=devices)
    step = make_dp_train_step(net_dp, loss_sum, mesh)
    shard = NamedSharding(mesh, PartitionSpec("data"))
    sg, sy = jax.device_put(stack_microbatches(micro), shard)
    log("data-parallel", "micro-batch senders shards (row -> device): "
                         + _shard_devices(sg.senders))
    new_state, loss = step(state, sg, sy, jax.random.key(0))
    log("data-parallel", f"{nd} devices, {k} graphs each; loss "
                         f"{float(loss):.6f} vs single {float(ref_loss):.6f}")
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    par_err = _tree_rel_l2(jax.device_get(new_state.params),
                           jax.device_get(ref_state.params))
    log("data-parallel", f"loss rel err {loss_err:.3e}; params after one "
                         f"Adam step rel L2 {par_err:.3e} (limit {tol:g})")
    if not (loss_err <= tol and par_err <= tol):
        raise AssertionError(f"data-parallel vs single device: loss "
                             f"{loss_err}, params {par_err}")
    return {"loss_rel_err": loss_err, "params_rel_l2": par_err}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-device phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    from egc_tpu.utils.compile_cache import enable_compile_cache
    from egc_tpu.utils.device import require_gpu

    require_gpu()
    enable_compile_cache()
    phase_device()
    if args.four_gpus:
        if jax.device_count() < 4:
            raise RuntimeError(f"--four-gpus needs 4 GPUs, have "
                               f"{jax.device_count()}")
        devices = jax.devices()[:4]
        phase_partitioned(arxiv_graph(), devices)
        phase_data_parallel(devices)
    else:
        raw = arxiv_graph()
        data = phase_trainer(raw)["data"]
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp)
        phase_attention(data)
        phase_reference(data)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
