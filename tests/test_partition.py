"""Distributed correctness gates (8-device virtual CPU mesh).

The central property (SURVEY §4): partitioned forward/training must
reproduce single-device numerics — halo exchange, global symnorm weights,
sync-BN, and psum'd gradients together make the partitioned step exactly
equivalent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from egc_tpu.data import synthetic
from egc_tpu.graph.structure import Graph
from egc_tpu.graph.transforms import symnorm_weight
from egc_tpu.models.nets import ConvSpec, ArxivNet, ZincNet
from egc_tpu.parallel import (
    make_mesh, partition_graph, halo_refresh, DistributedNodeClassifier,
    make_partitioned_train_step, make_dp_train_step, stack_microbatches,
)
from egc_tpu.train.optim import make_optimizer
from egc_tpu.train.state import TrainState

NUM_DEV = 8


def full_graph(seed=0, n=400, classes=6, feats=16):
    return synthetic.synthetic_full_graph(
        num_nodes=n, avg_degree=6, num_classes=classes, num_features=feats,
        seed=seed)


def test_partition_plan_invariants():
    raw = full_graph()
    n = raw["x"].shape[0]
    plan = partition_graph(raw["senders"], raw["receivers"], n, 4,
                           method="bfs")
    # every node owned exactly once
    assert plan.node_mask.sum() == n
    gids = plan.node_gids[plan.node_mask]
    assert sorted(gids.tolist()) == list(range(n))
    # every edge present exactly once, with correct endpoints
    edges = set(zip(raw["senders"].tolist(), raw["receivers"].tolist()))
    seen = set()
    for p in range(4):
        for j in np.where(plan.edge_mask[p])[0]:
            r_loc = plan.receivers_loc[p, j]
            s_ext = plan.senders_ext[p, j]
            r_gid = plan.node_gids[p, r_loc]
            if s_ext < plan.n_local:
                s_gid = plan.node_gids[p, s_ext]
            else:
                src_part = (s_ext - plan.n_local) // plan.halo
                pos = (s_ext - plan.n_local) % plan.halo
                s_gid = plan.node_gids[src_part,
                                       plan.send_idx[src_part, p, pos]]
            seen.add((int(s_gid), int(r_gid)))
    assert seen == edges


def test_halo_refresh_delivers_owner_values():
    raw = full_graph(seed=3)
    n = raw["x"].shape[0]
    plan = partition_graph(raw["senders"], raw["receivers"], n, NUM_DEV,
                           method="bfs")
    mesh = make_mesh({"graph": NUM_DEV})
    x_global = np.random.default_rng(0).normal(
        size=(n, 4)).astype(np.float32)
    x_local = plan.scatter_nodes(x_global)                  # [P, n_local, 4]
    x_ext = np.zeros((NUM_DEV, plan.n_ext, 4), np.float32)
    x_ext[:, :plan.n_local] = x_local

    def refresh(xe, sidx):
        return halo_refresh(xe[0], sidx[0], "graph")[None]

    fn = jax.jit(jax.shard_map(
        refresh, mesh=mesh, in_specs=(P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=True))
    out = np.asarray(fn(jnp.asarray(x_ext), jnp.asarray(plan.send_idx)))

    # check: for partition p, halo slot (q, h) must hold x_global of the node
    # q sends to p (when the slot is real)
    for p in range(NUM_DEV):
        for q in range(NUM_DEV):
            for h in np.where(plan.send_mask[q, p])[0]:
                gid = plan.node_gids[q, plan.send_idx[q, p, h]]
                got = out[p, plan.n_local + q * plan.halo + h]
                np.testing.assert_allclose(got, x_global[gid], rtol=1e-6)


@pytest.mark.parametrize("conv", [
    ConvSpec(kind="egc", heads=2, bases=2, aggrs=("symnorm", "max", "mean")),
    ConvSpec(kind="egc", heads=2, bases=2, aggrs=("sum", "std")),
    # the whole conv zoo must work partitioned: receiver-owned edge
    # assignment makes every owned receiver's in-neighborhood local, so
    # attention softmax / PNA degree stats are complete per partition
    ConvSpec(kind="gat", heads=2),
    ConvSpec(kind="gatv2", heads=2),
    ConvSpec(kind="pna", avg_log_deg=1.7),
], ids=["egc-symnorm", "egc-sum-std", "gat", "gatv2", "pna"])
def test_partitioned_forward_equals_single_device(conv):
    raw = full_graph(seed=5, n=300, classes=5, feats=8)
    n = raw["x"].shape[0]

    # single-device reference
    g = jax.tree.map(jnp.asarray, Graph.from_coo(
        raw["x"], raw["senders"], raw["receivers"]))
    net = ArxivNet(conv=conv, hidden_dim=16, num_layers=2, dropout=0.0,
                   residual=True, num_features=8, num_classes=5)
    variables = net.init(jax.random.key(0), g, train=False)
    ref = np.asarray(net.apply(variables, g, train=False))

    # partitioned
    ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                            jnp.asarray(raw["receivers"]), n)
    plan = partition_graph(raw["senders"], raw["receivers"], n, NUM_DEV,
                           method="bfs", sym_edge_w=np.asarray(ew),
                           sym_self_w=np.asarray(sw))
    x_local = plan.scatter_nodes(raw["x"])
    x_ext = np.zeros((NUM_DEV, plan.n_ext, 8), np.float32)
    x_ext[:, :plan.n_local] = x_local
    gl = plan.extended_graph(x_ext)
    dnet = DistributedNodeClassifier(conv=conv, hidden_dim=16, num_layers=2,
                                     dropout=0.0, residual=True,
                                     num_features=8, num_classes=5,
                                     e_interior=plan.e_interior)
    mesh = make_mesh({"graph": NUM_DEV})

    def fwd(graphs, sidx):
        graph = jax.tree.map(lambda a: a[0], graphs)
        out = dnet.apply(variables, graph, sidx[0], train=False)
        return out[None]

    fn = jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=True))
    out = np.asarray(fn(jax.tree.map(jnp.asarray, gl),
                        jnp.asarray(plan.send_idx)))
    got = plan.gather_nodes(out[:, :plan.n_local], n)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_partitioned_train_step_matches_single_device():
    raw = full_graph(seed=7, n=240, classes=4, feats=8)
    n = raw["x"].shape[0]
    conv = ConvSpec(kind="egc", heads=2, bases=2, aggrs=("symnorm", "max"))

    g = jax.tree.map(jnp.asarray, Graph.from_coo(
        raw["x"], raw["senders"], raw["receivers"]))
    net = ArxivNet(conv=conv, hidden_dim=16, num_layers=2, dropout=0.0,
                   residual=True, num_features=8, num_classes=4)
    variables = net.init(jax.random.key(1), g, train=False)
    # plain SGD so params-after-one-step compares gradients directly
    # (Adam's 1/sqrt(v) normalization would amplify 1e-7 grad noise)
    import optax
    tx = optax.sgd(1e-2)
    y = jnp.asarray(raw["y"])
    tmask = np.zeros(n, bool)
    tmask[raw["train_idx"]] = True
    tmask_j = jnp.asarray(tmask)

    # single-device step
    def loss_fn(params):
        out, mutated = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            g, train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
        nll = -jnp.take_along_axis(out, y[:, None], axis=1).reshape(-1)
        m = tmask_j.astype(out.dtype)
        return jnp.sum(nll * m) / jnp.sum(m), mutated

    (ref_loss, _), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    # partitioned step
    ew, sw = symnorm_weight(g.senders, g.receivers, n)
    plan = partition_graph(raw["senders"], raw["receivers"], n, NUM_DEV,
                           method="bfs", sym_edge_w=np.asarray(ew),
                           sym_self_w=np.asarray(sw))
    x_ext = np.zeros((NUM_DEV, plan.n_ext, 8), np.float32)
    x_ext[:, :plan.n_local] = plan.scatter_nodes(raw["x"])
    gl = jax.tree.map(jnp.asarray, plan.extended_graph(x_ext))
    dnet = DistributedNodeClassifier(conv=conv, hidden_dim=16, num_layers=2,
                                     dropout=0.0, residual=True,
                                     num_features=8, num_classes=4,
                                     e_interior=plan.e_interior)
    mesh = make_mesh({"graph": NUM_DEV})
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=tx)
    step = make_partitioned_train_step(dnet, mesh)
    labels_loc = jnp.asarray(plan.scatter_nodes(raw["y"]))
    tmask_loc = jnp.asarray(plan.scatter_nodes(tmask))
    new_state, loss = step(state, gl, jnp.asarray(plan.send_idx),
                           labels_loc, tmask_loc, jax.random.key(0))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)

    # gradients (via params after one SGD step) match single-device
    ref_params = jax.tree.map(lambda p, g_: p - 1e-2 * g_,
                              variables["params"], ref_grads)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                rtol=1e-4, atol=1e-6),
        jax.device_get(new_state.params), jax.device_get(ref_params))


def test_dp_step_matches_big_batch():
    data = synthetic.synthetic_zinc(num_graphs=64)
    graphs = data["train"][:32]
    conv = ConvSpec(kind="egc", heads=2, bases=2, aggrs=("symnorm",),
                    softmax=True)

    from egc_tpu.graph.structure import batch_np
    micro = []
    for d in range(NUM_DEV):
        micro.append(batch_np(graphs[d * 4:(d + 1) * 4], num_nodes=160,
                              num_edges=512, num_graphs=9))
    big_g, big_y = batch_np(graphs, num_nodes=8 * 160, num_edges=8 * 512,
                            num_graphs=8 * 9)

    def loss_sum(out, y, graph):
        err = jnp.abs(out.reshape(-1) - y.reshape(-1).astype(out.dtype))
        m = graph.graph_mask.astype(out.dtype)
        return jnp.sum(err * m), jnp.sum(m)

    net_dp = ZincNet(conv=conv, hidden_dim=16, num_layers=2, residual=True,
                     bn_axis="data")
    net_1d = ZincNet(conv=conv, hidden_dim=16, num_layers=2, residual=True)
    g0 = jax.tree.map(jnp.asarray, micro[0][0])
    variables = net_1d.init(jax.random.key(2), g0, train=False)
    tx = make_optimizer(1e-3, 0.0)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=tx)

    # single-device big batch step
    def loss_fn(params):
        out, mutated = net_1d.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jax.tree.map(jnp.asarray, big_g), train=True,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        s, c = loss_sum(out, jnp.asarray(big_y), big_g)
        return s / c, mutated

    (ref_loss, _), _ = jax.value_and_grad(loss_fn, has_aux=True)(state.params)

    mesh = make_mesh({"data": NUM_DEV})
    step = make_dp_train_step(net_dp, loss_sum, mesh)
    sg, sy = stack_microbatches(micro)
    new_state, loss = step(state, jax.tree.map(jnp.asarray, sg),
                           jnp.asarray(sy), jax.random.key(0))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-4)


def test_partitioned_config_end_to_end():
    """PartitionedArxivConfig trains through the standard runner."""
    from egc_tpu.exp.fullgraph import PartitionedArxivConfig
    from egc_tpu.exp.runner import run_trial

    cfg = PartitionedArxivConfig("egc", hidden=32, heads=4, bases=2,
                                 aggrs=("symnorm", "mean"),
                                 partitions=NUM_DEV)
    cfg.load_full_graph = lambda: synthetic.synthetic_full_graph(
        num_nodes=600, avg_degree=8, num_classes=6, num_features=16, seed=9)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.1}
    res = run_trial(cfg, hp, seed=0, max_iterations=20, patience=50,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.4, accs


def test_partitioned_restore_roundtrip(tmp_path):
    """Checkpoint restore of a partitioned trial rebuilds the RIGHT-shaped
    model (round-1 VERDICT weak #5: data must load before the model) and
    reproduces the trial's final metrics."""
    from egc_tpu.exp.fullgraph import PartitionedArxivConfig
    from egc_tpu.exp.runner import run_trial

    def mk():
        cfg = PartitionedArxivConfig("egc", hidden=32, heads=4, bases=2,
                                     aggrs=("symnorm", "max"),
                                     partitions=NUM_DEV)
        cfg.load_full_graph = lambda: synthetic.synthetic_full_graph(
            num_nodes=500, avg_degree=8, num_classes=5, num_features=24,
            seed=11)
        return cfg

    cfg = mk()
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.0}
    res = run_trial(cfg, hp, seed=0, max_iterations=6, patience=50,
                    trial_dir=tmp_path, verbose=False)
    ref = res["test"]

    # fresh config object (no cached model/data) restores from disk
    cfg2 = mk()
    model, state, plateau, hp2, data = cfg2.restore_trial(tmp_path)
    got = cfg2.test(model, state, data)
    # num_features=24 (not the 128 default): restore must be data-shaped
    assert got["val_acc"] == pytest.approx(ref["val_acc"], abs=1e-6)
    assert got["test_acc"] == pytest.approx(ref["test_acc"], abs=1e-6)
