"""On-device neighbor sampler gates (CPU; the program is pure XLA).

Structural exactness (every sampled edge exists in the graph, receivers
get exactly min(deg, fanout) DISTINCT in-neighbors, seeds occupy loss
slots), padding/short-batch behavior, determinism, uniformity of the
Floyd subsets, and budget agreement with the host sampler.
"""

import numpy as np
import jax
import jax.numpy as jnp

from egc_tpu.data.device_sampling import (
    DeviceNeighborSampler, DeviceSampledLoader, _floyd_subset,
)
from egc_tpu.data.sampling import NeighborSampler


def random_graph(rng, n=400, e=3000):
    s = rng.integers(0, n, e).astype(np.int64)
    r = rng.integers(0, n, e).astype(np.int64)
    pair = np.unique(np.stack([s, r], 1), axis=0)   # sampler assumes
    return pair[:, 0].copy(), pair[:, 1].copy()     # no duplicate edges


def in_adj(s, r, n):
    adj = {}
    for a, b in zip(s, r):
        adj.setdefault(b, set()).add(a)
    return adj


def test_structure_and_exact_counts(rng):
    n = 400
    s, r = random_graph(rng, n)
    samp = DeviceNeighborSampler(s, r, n, fanouts=(7, 4))
    seeds = rng.choice(n, 64, replace=False).astype(np.int32)
    gids, sl, rl, em, nm, n_nodes = jax.tree.map(
        np.asarray, samp.sample(jax.random.key(0), jnp.asarray(seeds)))

    assert np.array_equal(gids[:64], seeds)          # seeds in loss slots
    nn = int(n_nodes)
    valid_g = gids[nm]
    assert len(np.unique(valid_g)) == len(valid_g)   # dense unique ids
    assert nm.sum() == nn

    adj = in_adj(s, r, n)
    # every sampled edge exists; per-receiver senders distinct
    per_recv = {}
    for a, b in zip(sl[em], rl[em]):
        ga, gb = int(gids[a]), int(gids[b])
        assert ga in adj.get(gb, set()), (ga, gb)
        per_recv.setdefault(b, []).append(ga)
    for b, lst in per_recv.items():
        assert len(set(lst)) == len(lst), f"dup senders at {b}"
    # hop-0: every seed with in-edges gets exactly min(deg, 7)
    for i, seed in enumerate(seeds):
        deg = len(adj.get(int(seed), ()))
        got = len(per_recv.get(i, []))
        assert got == min(deg, 7), (seed, deg, got)


def test_short_batch_and_determinism(rng):
    n = 300
    s, r = random_graph(rng, n, 2000)
    samp = DeviceNeighborSampler(s, r, n, fanouts=(5, 3))
    seeds = np.full(32, n, np.int32)
    seeds[:10] = rng.choice(n, 10, replace=False)
    out1 = jax.tree.map(np.asarray,
                        samp.sample(jax.random.key(3), jnp.asarray(seeds)))
    out2 = jax.tree.map(np.asarray,
                        samp.sample(jax.random.key(3), jnp.asarray(seeds)))
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    gids, sl, rl, em, nm, _ = out1
    # padded seed slots are masked out and sample nothing
    assert not nm[10:32].any()
    assert set(np.unique(rl[em])).isdisjoint(range(10, 32))


def test_budgets_match_host_sampler(rng):
    n = 200
    s, r = random_graph(rng, n, 1500)
    dev = DeviceNeighborSampler(s, r, n, fanouts=(15, 10))
    host = NeighborSampler(s, r, n, fanouts=(15, 10))
    assert dev.budgets(1024) == host.budgets(1024)


def test_floyd_uniform_subsets():
    """Every in-neighbor of a node with deg > fanout is selected with
    equal probability fanout/deg (uniform k-subset)."""
    deg = jnp.full((2000,), 30)
    counts = np.zeros(30)
    sel, ok = _floyd_subset(jax.random.key(5), deg, 6)
    sel = np.asarray(sel)
    assert np.asarray(ok).all()
    for row in sel:
        assert len(set(row.tolist())) == 6       # distinct
        counts[row] += 1
    freq = counts / 2000
    np.testing.assert_allclose(freq, 6 / 30, atol=0.025)


def test_loader_items_and_training_smoke(rng):
    n, f = 500, 16
    s, r = random_graph(rng, n, 4000)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    samp = DeviceNeighborSampler(s, r, n, fanouts=(5, 3))
    loader = DeviceSampledLoader(samp, y, np.arange(200), 64, rng_seed=2)
    assert len(loader) == 4

    from egc_tpu.models.nets import ConvSpec, ArxivNet
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu.train.state import TrainState

    net = ArxivNet(conv=ConvSpec(kind="egc", heads=2, bases=2,
                                 aggrs=("symnorm", "max")),
                   hidden_dim=16, num_layers=2, dropout=0.0,
                   residual=True, num_features=f, num_classes=5)
    x_full = jnp.asarray(x)
    items = list(loader)
    g0, y0, m0, gid0 = items[0]
    g0x = g0.replace(nodes=jnp.take(x_full, jnp.minimum(gid0, n - 1),
                                    axis=0))
    variables = net.init(jax.random.key(0), g0x, train=False)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=make_optimizer(1e-2, 0.0))

    @jax.jit
    def step(state, g, gids, y, m, rng):
        g = g.replace(nodes=jnp.take(x_full, jnp.minimum(gids, n - 1),
                                     axis=0))

        def loss_fn(params, bs):
            out, mut = net.apply({"params": params, "batch_stats": bs}, g,
                                 train=True, rngs={"dropout": rng},
                                 mutable=["batch_stats"])
            nll = -jnp.sum(out * jax.nn.one_hot(y, 5), axis=1)
            mm = m.astype(out.dtype)
            return jnp.sum(nll * mm) / jnp.maximum(jnp.sum(mm), 1.0), \
                mut["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats)
        return state.apply_gradients(grads, new_batch_stats=bs), loss

    losses = []
    for ep in range(3):
        for g, yb, mb, gids in loader:
            state, loss = step(state, g, gids, yb, mb,
                               jax.random.key(ep))
            losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
