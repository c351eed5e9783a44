"""Heterogeneous ogbn-mag (rmag) experiment config.

Reference counterpart ``experiments/rmag/configs.py``: full-graph hetero
node classification on paper nodes; REGConv layers (final RGCNConv); Choice
hyperparameter grids; 200 iters / patience 50; plateau patience 10.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from egc_tpu.data import synthetic
from egc_tpu.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu.exp.hyperparams import ChoiceHyperParam
from egc_tpu.graph.hetero import hetero_from_numpy
from egc_tpu.nn.conv.hetero import REGCNet
from egc_tpu.train.loop import make_train_step, make_eval_step
from egc_tpu.train.optim import plateau_init
from egc_tpu.train.state import TrainState


class RMagConfig(ExperimentConfig):
    name = "rmag"
    num_layers = 2                     # reference rmag/configs.py:23

    def __init__(self, hidden: int, *, heads: int = 4, bases: int = 4,
                 use_egc: bool = True):
        self.hidden = hidden
        self.heads = heads
        self.bases = bases
        self.use_egc = use_egc
        self._train_step = None
        self._eval_step = None

    def settings(self):
        return ExperimentSettings("rmag", final_repeats=10,
                                  final_max_iterations=200)

    def stoppers(self):
        return StopperSpec(patience=50, max_iters=200)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        # fixed hparams: empty grid (reference rmag/configs.py:118-119)
        from egc_tpu.exp.search import GridSearchStrategy
        return GridSearchStrategy({})

    def hyperparams(self):
        # reference rmag/configs.py:137-139
        return {
            "lr": ChoiceHyperParam([0.001, 0.01, 0.05, 0.1], default=0.01),
            "wd": ChoiceHyperParam([5e-5, 1e-4, 5e-4, 1e-3], default=1e-3),
            "dropout": ChoiceHyperParam([0.3, 0.5, 0.7], default=0.5),
        }

    def plateau(self, hparams):
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=10, min_lr=1e-5)

    def load_hetero(self) -> Dict[str, Any]:
        if self.synthetic:
            return synthetic.synthetic_rmag()
        from egc_tpu.data.ondisk import load_ogbn_mag_hetero
        return load_ogbn_mag_hetero()

    def data(self, hparams):
        raw = self.load_hetero()
        hg = jax.tree.map(jnp.asarray,
                          hetero_from_numpy(raw["nodes"], raw["edges"]))
        n_paper = hg.num_nodes("paper")
        y = np.zeros(n_paper, np.int32)
        y[:len(raw["y"])] = raw["y"]
        masks = {}
        for split in ("train", "val", "test"):
            m = np.zeros(n_paper, bool)
            m[raw[f"{split}_idx"]] = True
            masks[split] = jnp.asarray(m)
        featless = tuple(sorted(t for t, x in raw["nodes"].items()
                                if x.shape[-1] == 0))
        d = {"hetero": hg, "y": jnp.asarray(y), "masks": masks,
             "num_classes": raw["num_classes"],
             "featureless": featless,
             "in_features": raw["nodes"]["paper"].shape[-1]}
        self._last_data = d
        return d

    def model(self, hparams):
        # net shape depends on data metadata (class count, featureless
        # types); the runner calls data() first, so reuse its result.
        data = getattr(self, "_last_data", None) or self.data(hparams)
        return REGCNet(hidden_dim=self.hidden, num_layers=self.num_layers,
                       dropout=float(hparams.get("dropout", 0.5)),
                       use_egc=self.use_egc, heads=self.heads,
                       bases=self.bases,
                       num_classes=data["num_classes"],
                       in_features=data["in_features"],
                       featureless_types=data["featureless"])

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        variables = jax.jit(model.init, static_argnames=("train",))(
            self.rng(seed), data["hetero"], train=False)
        return TrainState.create(params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 tx=self.optimizer(hparams))

    def train(self, model, state, data, rng, iteration: int):
        step = self._get_steps(model)
        state, loss = step["train"](
            state, data["hetero"], (data["y"], data["masks"]["train"]),
            jax.random.fold_in(rng, iteration))
        return state, {"train_loss": float(loss)}

    def _get_steps(self, model):
        cache = getattr(self, "_steps_cache", None)
        if cache is None:
            cache = self._steps_cache = {}
        if model not in cache:

            def loss_fn(out, y, hg):
                from egc_tpu.train.losses import gather_label_scores
                labels, train_mask = y
                nll = -gather_label_scores(out, labels)
                m = train_mask.astype(out.dtype)
                return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

            cache[model] = {"train": make_train_step(model, loss_fn),
                            "eval": make_eval_step(model)}
        return cache[model]

    def val(self, model, state, data):
        from egc_tpu.train.metrics import split_accuracies
        steps = self._get_steps(model)
        out = steps["eval"](state, data["hetero"])
        return split_accuracies(out, data["y"], data["masks"])

    def test(self, model, state, data):
        return self.val(model, state, data)


class PartitionedRMagConfig(RMagConfig):
    """rmag trained across a ``graph`` mesh axis: every node TYPE is
    partitioned (per-type halo exchange, egc_tpu.parallel.hetero_halo);
    featureless-type embeddings are device-local trainable rows carried in
    ``state.batch_stats`` (sharded leaves must not sit in the replicated
    params pytree); their optimizer matches the single-device one
    (L2-into-grad Adam, and ``train`` re-syncs its lr from the conv
    optimizer each step so plateau decays apply to both). Same hook
    surface as RMagConfig. Numerics equal the single-device config
    (tests/test_hetero_partition.py).
    """

    def __init__(self, *args, partitions: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.partitions = partitions or jax.device_count()
        self._mesh = None
        self._hsteps = None

    def data(self, hparams):
        from egc_tpu.parallel.mesh import make_mesh
        from egc_tpu.parallel.hetero_partition import partition_hetero

        raw = self.load_hetero()
        hg = hetero_from_numpy(raw["nodes"], raw["edges"])
        num_nodes = {t: hg.num_nodes(t) for t in hg.node_types}
        plan = partition_hetero(num_nodes, raw["edges"], self.partitions)

        featless = tuple(sorted(t for t, x in raw["nodes"].items()
                                if x.shape[-1] == 0))
        x_stack = {}
        for t in hg.node_types:
            tp = plan.types[t]
            if t in featless:
                x_stack[t] = np.zeros(
                    (self.partitions, tp.n_ext, 0), np.float32)
            else:
                x_loc = tp.scatter(np.asarray(hg.nodes[t]))
                x_stack[t] = np.pad(
                    x_loc, ((0, 0), (0, tp.n_ext - tp.n_local), (0, 0)))
        # hg.nodes is never read by the distributed net (features flow
        # through the explicit x/emb step arguments) — hold zero-width
        # placeholders so mag-scale features are not duplicated on device.
        self._mesh = make_mesh({"graph": self.partitions})
        # every per-partition array lives on its partition's device
        shard = partial(jax.device_put, device=NamedSharding(
            self._mesh, PartitionSpec("graph")))
        hg_stack = jax.tree.map(shard, plan.extended_hetero_graph(
            {t: np.zeros(v.shape[:2] + (0,), np.float32)
             for t, v in x_stack.items()}))
        pp = plan.types["paper"]
        n_paper = hg.num_nodes("paper")
        y = np.zeros(n_paper, np.int32)
        y[:len(raw["y"])] = raw["y"]
        masks = {}
        for split in ("train", "val", "test"):
            m = np.zeros(n_paper, bool)
            m[raw[f"{split}_idx"]] = True
            masks[split] = shard(pp.scatter(m))
        d = {"plan": plan, "hetero": hg_stack,
             "x_stack": {t: shard(v) for t, v in x_stack.items()},
             "send_idx": {t: shard(plan.types[t].send_idx)
                          for t in hg.node_types},
             "y": shard(pp.scatter(y)),
             "masks": masks,
             "num_classes": raw["num_classes"],
             "featureless": featless,
             "in_features": raw["nodes"]["paper"].shape[-1],
             "n_ext_map": {t: plan.types[t].n_ext for t in featless}}
        self._last_data = d
        return d

    def model(self, hparams):
        from egc_tpu.parallel.hetero_halo import DistributedREGCNet

        data = getattr(self, "_last_data", None) or self.data(hparams)
        return DistributedREGCNet(
            hidden_dim=self.hidden, num_layers=self.num_layers,
            dropout=float(hparams.get("dropout", 0.5)),
            use_egc=self.use_egc, heads=self.heads, bases=self.bases,
            num_classes=data["num_classes"])

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        import optax
        from egc_tpu.nn import init as einit
        from egc_tpu.parallel.hetero_halo import init_hetero_partitioned

        self._last_data = data
        model = self.model(hparams)
        self._model_obj = model
        plan = data["plan"]
        rng = self.rng(seed)
        emb = {}
        for i, t in enumerate(data["featureless"]):
            tp = plan.types[t]
            n_t = tp.owner.shape[0]
            table = einit.glorot_uniform(
                jax.random.fold_in(rng, i + 1),
                (n_t, data["in_features"]), jnp.float32)
            emb[t] = jnp.asarray(tp.scatter(np.asarray(table)))
        from egc_tpu.train.optim import make_optimizer
        emb_tx = make_optimizer(float(hparams.get("lr", 0.01)),
                                float(hparams.get("wd", 0.0)))
        emb_opt = jax.vmap(emb_tx.init)(emb)
        self._emb_tx = emb_tx

        x_with_emb = dict(data["x_stack"])
        from egc_tpu.parallel.hetero_halo import extend_local
        for t in data["featureless"]:
            x_with_emb[t] = extend_local(emb[t], data["n_ext_map"][t])
        variables = init_hetero_partitioned(
            model, self._mesh, data["hetero"], x_with_emb,
            data["send_idx"], rng)
        return TrainState.create(
            params=variables["params"],
            batch_stats={"emb": emb, "emb_opt": emb_opt},
            tx=self.optimizer(hparams))

    def _get_steps(self, model):
        # the jitted steps close over emb_tx/mesh/n_ext_map, so key the
        # cache on those too (a later init_state builds a new emb_tx with
        # the trial's lr/wd while the model dataclass compares equal)
        key = (model, id(self._emb_tx), id(self._mesh))
        if self._hsteps is None or self._hsteps_key != key:
            from egc_tpu.parallel.hetero_halo import (
                build_hetero_partitioned_steps)
            data = self._last_data
            self._hsteps = build_hetero_partitioned_steps(
                model, self._mesh, self._emb_tx, data["n_ext_map"])
            self._hsteps_key = key
        return self._hsteps

    def train(self, model, state, data, rng, iteration: int):
        model = getattr(self, "_model_obj", model)
        train_step, _ = self._get_steps(model)
        emb = state.batch_stats["emb"]
        emb_opt = state.batch_stats["emb_opt"]
        # plateau decays adjust the conv optimizer's lr via set_lr; mirror
        # the current value into the (sharded) embedding optimizer state
        from egc_tpu.train.optim import get_lr
        lr_now = get_lr(state.opt_state)
        emb_opt.hyperparams["learning_rate"] = jnp.full_like(
            emb_opt.hyperparams["learning_rate"], lr_now)
        slim = state.replace(batch_stats={})
        slim, new_emb, new_opt, loss = train_step(
            slim, emb, emb_opt, data["hetero"], data["x_stack"],
            data["send_idx"], data["y"], data["masks"]["train"],
            jax.random.fold_in(rng, iteration))
        state = slim.replace(
            batch_stats={"emb": new_emb, "emb_opt": new_opt})
        return state, {"train_loss": float(loss)}

    def val(self, model, state, data):
        model = getattr(self, "_model_obj", model)
        _, eval_step = self._get_steps(model)
        slim = state.replace(batch_stats={})
        out = eval_step(slim, state.batch_stats["emb"], data["hetero"],
                        data["x_stack"], data["send_idx"])
        from egc_tpu.train.metrics import split_accuracies
        plan = data["plan"]
        pp = plan.types["paper"]
        return split_accuracies(out[:, :pp.n_local], data["y"],
                                data["masks"])

    def test(self, model, state, data):
        return self.val(model, state, data)
