"""Partitioned hetero (rmag) training: plan invariants + single-device
equivalence on the virtual 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from egc_tpu.data import synthetic
from egc_tpu.graph.hetero import hetero_from_numpy, split_rel_key
from egc_tpu.nn.conv.hetero import REGCNet
from egc_tpu.parallel.hetero_partition import partition_hetero
from egc_tpu.parallel.hetero_halo import (
    DistributedREGCNet, build_hetero_partitioned_steps, extend_local,
    init_hetero_partitioned)
from egc_tpu.parallel.mesh import make_mesh

NUM_DEV = 8


def _setup(seed=0):
    raw = synthetic.synthetic_rmag(num_paper=300, num_author=150,
                                   num_inst=20, num_fos=30, num_classes=6,
                                   num_features=16, seed=seed)
    hg = hetero_from_numpy(raw["nodes"], raw["edges"])
    num_nodes = {t: hg.num_nodes(t) for t in hg.node_types}
    plan = partition_hetero(num_nodes, raw["edges"], NUM_DEV)
    return raw, hg, plan


def test_hetero_plan_invariants():
    raw, hg, plan = _setup()
    for t, tp in plan.types.items():
        n_t = hg.num_nodes(t)
        # every global node owned exactly once
        assert tp.owner.shape == (n_t,)
        gids = tp.node_gids[tp.node_gids >= 0]
        assert sorted(gids.tolist()) == list(range(n_t))
    for key, (s, r) in raw["edges"].items():
        src, _, dst = split_rel_key(key)
        rp = plan.rels[key]
        sp, dp = plan.types[src], plan.types[dst]
        # reconstruct global (sender, receiver) pairs from the local lists
        got = []
        for p in range(NUM_DEV):
            em = rp.edge_mask[p]
            se = rp.senders_ext[p][em]
            rl = rp.receivers_loc[p][em]
            r_glob = dp.node_gids[p][rl]
            # senders: local rows resolve via node_gids; halo rows via the
            # send lists (slot n_local + q*halo + pos holds q's send_idx)
            s_glob = np.empty(len(se), np.int64)
            local = se < sp.n_local
            s_glob[local] = sp.node_gids[p][se[local]]
            hs = se[~local] - sp.n_local
            q, pos = hs // sp.halo, hs % sp.halo
            s_glob[~local] = sp.node_gids[q, sp.send_idx[q, p, pos]]
            assert sp.send_mask[q, p, pos].all()
            got.append(np.stack([s_glob, r_glob]))
        got = np.concatenate(got, axis=1)
        want = np.stack([np.asarray(s, np.int64), np.asarray(r, np.int64)])
        assert got.shape == want.shape
        n_dst = hg.num_nodes(dst)
        got_k = np.sort(got[0] * n_dst + got[1])
        want_k = np.sort(want[0] * n_dst + want[1])
        assert (got_k == want_k).all()


def _single_device_ref(raw, hg, dropout=0.0, train=False, seed=0):
    featless = tuple(sorted(t for t, x in raw["nodes"].items()
                            if x.shape[-1] == 0))
    net = REGCNet(hidden_dim=16, num_layers=2, dropout=dropout,
                  use_egc=True, heads=2, bases=2,
                  num_classes=raw["num_classes"], in_features=16,
                  featureless_types=featless, target_type="paper")
    g = jax.tree.map(jnp.asarray, hg)
    variables = net.init(jax.random.key(seed), g, train=False)
    return net, variables, featless


def _distributed(raw, hg, plan, variables, featless):
    dnet = DistributedREGCNet(hidden_dim=16, num_layers=2, dropout=0.0,
                              use_egc=True, heads=2, bases=2,
                              num_classes=raw["num_classes"],
                              target_type="paper")
    params = dict(variables["params"])
    emb_global = {t: np.asarray(params.pop(f"emb_{t}")) for t in featless}
    x_stack, emb = {}, {}
    for t in hg.node_types:
        tp = plan.types[t]
        if t in featless:
            emb[t] = jnp.asarray(tp.scatter(emb_global[t]))
            x_stack[t] = jnp.zeros((NUM_DEV, tp.n_ext, 0), jnp.float32)
        else:
            x_loc = tp.scatter(np.asarray(hg.nodes[t]))
            x_stack[t] = jnp.asarray(
                np.pad(x_loc, ((0, 0), (0, tp.n_ext - tp.n_local), (0, 0))))
    hg_stack = jax.tree.map(
        jnp.asarray,
        plan.extended_hetero_graph({t: np.asarray(v)
                                    for t, v in x_stack.items()}))
    send_idx = {t: jnp.asarray(plan.types[t].send_idx)
                for t in hg.node_types}
    return dnet, {"params": params}, x_stack, emb, hg_stack, send_idx


def test_hetero_partitioned_forward_equals_single_device():
    raw, hg, plan = _setup(seed=3)
    net, variables, featless = _single_device_ref(raw, hg)
    g = jax.tree.map(jnp.asarray, hg)
    ref = np.asarray(net.apply(variables, g, train=False))

    dnet, dvars, x_stack, emb, hg_stack, send_idx = _distributed(
        raw, hg, plan, variables, featless)
    mesh = make_mesh({"graph": NUM_DEV})
    try:
        from jax import shard_map as shard_map_fn
    except ImportError:
        from jax.experimental.shard_map import shard_map as shard_map_fn
    from jax.sharding import PartitionSpec as P

    n_ext_map = {t: plan.types[t].n_ext for t in featless}

    def fwd(hg_, x_, emb_, sidx_):
        h = jax.tree.map(lambda a: a[0], hg_)
        x = {t: v[0] for t, v in x_.items()}
        x.update({t: extend_local(v[0], n_ext_map[t])
                  for t, v in emb_.items()})
        sidx = {t: v[0] for t, v in sidx_.items()}
        out = dnet.apply(dvars, h, x, sidx, train=False)
        return out[None]

    fn = jax.jit(shard_map_fn(
        fwd, mesh=mesh,
        in_specs=(P("graph"), P("graph"), P("graph"), P("graph")),
        out_specs=P("graph"), check_vma=True))
    out = np.asarray(fn(hg_stack, x_stack, emb, send_idx))

    pp = plan.types["paper"]
    got = pp.gather(out[:, :pp.n_local], hg.num_nodes("paper"))
    valid = np.asarray(hg.node_mask["paper"])
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)


def test_hetero_partitioned_train_step_matches_single_device():
    raw, hg, plan = _setup(seed=5)
    net, variables, featless = _single_device_ref(raw, hg)
    g = jax.tree.map(jnp.asarray, hg)
    n_paper = hg.num_nodes("paper")
    y = np.zeros(n_paper, np.int32)
    y[:len(raw["y"])] = raw["y"]
    tmask = np.zeros(n_paper, bool)
    tmask[raw["train_idx"]] = True

    lr, wd = 0.05, 1e-3
    from egc_tpu.train.optim import make_optimizer
    tx = make_optimizer(lr, wd)   # L2-into-grad Adam, the production tx

    # single-device reference step over ALL params (incl. embeddings)
    def ref_loss(params):
        out = net.apply({"params": params}, g, train=True,
                        rngs={"dropout": jax.random.key(9)})
        nll = -jnp.take_along_axis(out, jnp.asarray(y)[:, None],
                                   axis=1)[:, 0]
        m = jnp.asarray(tmask).astype(out.dtype)
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    ref_l, ref_g = jax.value_and_grad(ref_loss)(variables["params"])
    opt_state = tx.init(variables["params"])
    upd, _ = tx.update(ref_g, opt_state, variables["params"])
    ref_new = optax.apply_updates(variables["params"], upd)

    # partitioned step
    dnet, dvars, x_stack, emb, hg_stack, send_idx = _distributed(
        raw, hg, plan, variables, featless)
    mesh = make_mesh({"graph": NUM_DEV})
    n_ext_map = {t: plan.types[t].n_ext for t in featless}
    from egc_tpu.train.state import TrainState
    state = TrainState.create(params=dvars["params"], batch_stats={},
                              tx=tx)
    emb_tx = make_optimizer(lr, wd)
    emb_opt = jax.vmap(emb_tx.init)(emb)
    pp = plan.types["paper"]
    y_loc = jnp.asarray(pp.scatter(y))
    m_loc = jnp.asarray(pp.scatter(tmask))

    train_step, _ = build_hetero_partitioned_steps(
        dnet, mesh, emb_tx, n_ext_map)
    new_state, new_emb, _, loss = train_step(
        state, emb, emb_opt, hg_stack, x_stack, send_idx, y_loc, m_loc,
        jax.random.key(9))

    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
    # shared (conv) params follow the single-device trajectory
    flat_ref = jax.tree_util.tree_leaves_with_path(
        {k: v for k, v in ref_new.items() if not k.startswith("emb_")})
    flat_got = jax.tree_util.tree_leaves_with_path(dict(new_state.params))
    assert len(flat_ref) == len(flat_got)
    for (kr, vr), (kg, vg) in zip(
            sorted(flat_ref, key=lambda kv: str(kv[0])),
            sorted(flat_got, key=lambda kv: str(kv[0]))):
        np.testing.assert_allclose(np.asarray(vg), np.asarray(vr),
                                   rtol=5e-3, atol=1e-5, err_msg=str(kr))
    # embedding rows follow too (device-local Adam on local grads)
    for t in featless:
        tp = plan.types[t]
        got = tp.gather(np.asarray(new_emb[t]), hg.num_nodes(t))
        want = np.asarray(ref_new[f"emb_{t}"])
        valid = np.asarray(hg.node_mask[t])
        np.testing.assert_allclose(got[valid], want[valid],
                                   rtol=5e-3, atol=1e-5, err_msg=t)


def test_partitioned_rmag_config_end_to_end():
    """PartitionedRMagConfig trains (and learns) through the runner."""
    from egc_tpu.exp.hetero import PartitionedRMagConfig
    from egc_tpu.exp.runner import run_trial

    cfg = PartitionedRMagConfig(hidden=32, heads=4, bases=2,
                                partitions=NUM_DEV)
    cfg.synthetic = True
    cfg.load_hetero = lambda: synthetic.synthetic_rmag(
        num_paper=300, num_author=150, num_inst=20, num_fos=30,
        num_classes=6, num_features=32, seed=4)
    hp = {"lr": 0.01, "wd": 1e-4, "dropout": 0.2}
    res = run_trial(cfg, hp, seed=0, max_iterations=25, patience=100,
                    verbose=False)
    accs = [h["val_acc"] for h in res["history"]]
    assert max(accs) > 0.5, accs


def test_partitioned_rmag_restore_roundtrip(tmp_path):
    """Checkpoint restore must round-trip the device-local embedding rows
    and their optimizer state (they live in state.batch_stats) and
    reproduce the trial's final metrics."""
    from egc_tpu.exp.hetero import PartitionedRMagConfig
    from egc_tpu.exp.runner import run_trial

    def mk():
        cfg = PartitionedRMagConfig(hidden=32, heads=4, bases=2,
                                    partitions=NUM_DEV)
        cfg.synthetic = True
        cfg.load_hetero = lambda: synthetic.synthetic_rmag(
            num_paper=240, num_author=120, num_inst=16, num_fos=24,
            num_classes=5, num_features=16, seed=6)
        return cfg

    cfg = mk()
    hp = {"lr": 0.01, "wd": 1e-4, "dropout": 0.0}
    res = run_trial(cfg, hp, seed=0, max_iterations=5, patience=50,
                    trial_dir=tmp_path, verbose=False)
    ref = res["test"]

    cfg2 = mk()
    model, state, plateau, hp2, data = cfg2.restore_trial(tmp_path)
    assert "emb" in state.batch_stats and "emb_opt" in state.batch_stats
    got = cfg2.test(model, state, data)
    assert got["val_acc"] == pytest.approx(ref["val_acc"], abs=1e-6)
    assert got["test_acc"] == pytest.approx(ref["test_acc"], abs=1e-6)
