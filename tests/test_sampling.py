"""Neighbor-sampling loader tests."""

import numpy as np
import jax
import jax.numpy as jnp

from egc_tpu.data import synthetic
from egc_tpu.data.sampling import NeighborSampler, SampledNodeLoader
from egc_tpu.models.nets import ConvSpec, ArxivNet


def test_sampler_invariants():
    raw = synthetic.synthetic_full_graph(num_nodes=500, avg_degree=8,
                                         num_classes=5, num_features=8)
    n = raw["x"].shape[0]
    sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                              fanouts=(5, 3))
    seeds = raw["train_idx"][:16]
    gids, s, r, n_seed = sampler.sample(seeds)
    assert n_seed == 16 and (gids[:16] == seeds).all()
    # every sampled edge is a real edge (u -> v in the original graph)
    real = set(zip(raw["senders"].tolist(), raw["receivers"].tolist()))
    for j in range(len(s)):
        assert (int(gids[s[j]]), int(gids[r[j]])) in real
    # fanout respected: each receiver gets at most fanout in-edges per hop
    nb, eb = sampler.budgets(16)
    assert len(gids) <= nb and len(s) <= eb


def test_sampled_training_learns():
    raw = synthetic.synthetic_full_graph(num_nodes=600, avg_degree=10,
                                         num_classes=5, num_features=16,
                                         seed=2)
    n = raw["x"].shape[0]
    sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                              fanouts=(8, 4))
    loader = SampledNodeLoader(sampler, raw["x"], raw["y"],
                               raw["train_idx"], batch_size=32)

    import optax
    from egc_tpu.train.state import TrainState
    net = ArxivNet(conv=ConvSpec(kind="egc", heads=2, bases=2,
                                 aggrs=("symnorm", "mean")),
                   hidden_dim=32, num_layers=2, dropout=0.0, residual=True,
                   num_features=16, num_classes=5)
    g0, y0, m0 = next(iter(loader))
    g0j = jax.tree.map(jnp.asarray, g0)
    variables = net.init(jax.random.key(0), g0j, train=False)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.adam(5e-3))

    import functools

    @jax.jit
    def step(state, g, y, m):
        def loss_fn(params):
            out, mut = net.apply(
                {"params": params, "batch_stats": state.batch_stats},
                g, train=True, rngs={"dropout": jax.random.key(0)},
                mutable=["batch_stats"])
            nll = -jnp.take_along_axis(out, y[:, None], axis=1).reshape(-1)
            mm = m.astype(out.dtype)
            return jnp.sum(nll * mm) / jnp.sum(mm), mut["batch_stats"]
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), loss

    losses = []
    for epoch in range(6):
        tot, cnt = 0.0, 0
        for g, y, m in loader:
            g = jax.tree.map(jnp.asarray, g)
            state, loss = step(state, g, jnp.asarray(y), jnp.asarray(m))
            tot += float(loss)
            cnt += 1
        losses.append(tot / cnt)
    assert losses[-1] < 0.7 * losses[0], losses


def test_sampled_mag_config_end_to_end():
    from egc_tpu.exp.fullgraph import SampledMagConfig
    from egc_tpu.exp.runner import run_trial

    cfg = SampledMagConfig("egc", hidden=32, heads=4, bases=2,
                           aggrs=("symnorm",), fanouts=(6, 4),
                           batch_size=64)
    cfg.load_full_graph = lambda: synthetic.synthetic_full_graph(
        num_nodes=500, avg_degree=8, num_classes=6, num_features=128,
        seed=3)
    # MagNet emits 349-rounded classes; synthetic has 6 — override out dims
    from egc_tpu.models.nets import MagNet
    cfg.model = lambda hp: MagNet(hidden_dim=32, num_layers=2,
                                  dropout=0.1, heads=4, bases=2,
                                  aggrs=("symnorm",), out_rounded=8,
                                  out_true=6)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.1}
    res = run_trial(cfg, hp, seed=0, max_iterations=8, patience=50,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.35, accs


def test_sampled_loader_prefetch_matches_sync_and_plans_static():
    """Prefetched batches equal the synchronous loader's, and every batch
    has the same (budget-static) array shapes: one jit compilation."""
    raw = synthetic.synthetic_full_graph(num_nodes=600, avg_degree=10,
                                         num_classes=5, num_features=8,
                                         seed=4)
    n = raw["x"].shape[0]
    sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                              fanouts=(6, 3))

    def mk(prefetch):
        return SampledNodeLoader(sampler, raw["x"], raw["y"],
                                 raw["train_idx"], batch_size=32,
                                 shuffle=True, rng_seed=7,
                                 prefetch=prefetch)

    sync = list(mk(0))
    pre = list(mk(3))
    assert len(sync) == len(pre) > 1
    shapes = None
    for (g1, y1, m1), (g2, y2, m2) in zip(sync, pre):
        # identical batches regardless of prefetch (per-batch rng streams)
        np.testing.assert_array_equal(np.asarray(g1.senders),
                                      np.asarray(g2.senders))
        np.testing.assert_array_equal(y1, y2)
        np.testing.assert_array_equal(m1, m2)
        s = tuple(np.shape(a) for a in jax.tree.leaves(g1))
        if shapes is None:
            shapes = s
        assert s == shapes


def test_sampled_dp_training_learns():
    """Sampling-parallel DP: seed shards across an 8-device 'data' mesh,
    sync-BN, psum'd masked loss — the MAG-scale distributed recipe."""
    from jax.sharding import PartitionSpec as P
    from egc_tpu.parallel import make_mesh, make_dp_train_step
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu.train.state import TrainState

    NUM_DEV = 8
    raw = synthetic.synthetic_full_graph(num_nodes=600, avg_degree=10,
                                         num_classes=5, num_features=16,
                                         seed=8)
    n = raw["x"].shape[0]
    sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                              fanouts=(8, 4))
    # one loader per device: disjoint seed shards (the documented recipe)
    seeds = raw["train_idx"]
    shards = np.array_split(seeds, NUM_DEV)
    loaders = [SampledNodeLoader(sampler, raw["x"], raw["y"], sh,
                                 batch_size=24, shuffle=True, rng_seed=d)
               for d, sh in enumerate(shards)]

    net = ArxivNet(conv=ConvSpec(kind="egc", heads=2, bases=2,
                                 aggrs=("symnorm", "mean")),
                   hidden_dim=32, num_layers=2, dropout=0.0, residual=True,
                   bn_axis="data", num_features=16, num_classes=5)

    def loss_sum(out, y, graph):
        labels, seed_mask = y
        nll = -jnp.take_along_axis(out, labels[:, None], axis=1)[:, 0]
        m = seed_mask.astype(out.dtype)
        return jnp.sum(nll * m), jnp.sum(m)

    mesh = make_mesh({"data": NUM_DEV})
    # init on one microbatch inside the mesh (sync-BN needs the axis)
    items = [next(iter(ld)) for ld in loaders]
    g_stack = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                           *[i[0] for i in items])
    y_stack = (jnp.asarray(np.stack([i[1] for i in items])),
               jnp.asarray(np.stack([i[2] for i in items])))

    try:
        from jax import shard_map as sm
    except ImportError:
        from jax.experimental.shard_map import shard_map as sm

    def init_fn(gs):
        g0 = jax.tree.map(lambda a: a[0], gs)
        return net.init(jax.random.key(0), g0, train=False)

    variables = jax.jit(sm(init_fn, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P(), check_vma=True))(g_stack)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=make_optimizer(1e-2, 0.0))
    step = make_dp_train_step(net, loss_sum, mesh)

    first = last = None
    for epoch in range(8):
        iters = [iter(ld) for ld in loaders]
        while True:
            try:
                items = [next(it) for it in iters]
            except StopIteration:
                break
            g_stack = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                                   *[i[0] for i in items])
            y_stack = (jnp.asarray(np.stack([i[1] for i in items])),
                       jnp.asarray(np.stack([i[2] for i in items])))
            state, loss = step(state, g_stack, y_stack,
                               jax.random.fold_in(jax.random.key(1), epoch))
            if first is None:
                first = float(loss)
            last = float(loss)
    assert last < first * 0.7, (first, last)


def test_sampled_mag_config_device_sampler_end_to_end():
    """SampledMagConfig(device_sampler=True): the in-step device sampler
    is a product path — same experiment surface, learning gate, and
    deterministic full-graph eval as the host-sampler config."""
    from egc_tpu.exp.fullgraph import SampledMagConfig
    from egc_tpu.exp.runner import run_trial

    cfg = SampledMagConfig("egc", hidden=32, heads=4, bases=2,
                           aggrs=("symnorm",), fanouts=(6, 4),
                           batch_size=64, device_sampler=True)
    cfg.load_full_graph = lambda: synthetic.synthetic_full_graph(
        num_nodes=500, avg_degree=8, num_classes=6, num_features=128,
        seed=3)
    from egc_tpu.models.nets import MagNet
    cfg.model = lambda hp: MagNet(hidden_dim=32, num_layers=2,
                                  dropout=0.1, heads=4, bases=2,
                                  aggrs=("symnorm",), out_rounded=8,
                                  out_true=6)
    hp = {"lr": 0.01, "wd": 0.0, "dropout": 0.1}
    res = run_trial(cfg, hp, seed=0, max_iterations=8, patience=50,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.35, accs
