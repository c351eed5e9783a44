"""Full-graph (transductive) experiment configs: ogbn-arxiv and ogbn-mag.

Reference counterparts: ``experiments/arxiv/configs.py`` (one full-batch
fwd/bwd per epoch, NLL on the train split, accuracy evaluator on all three
splits, plateau patience 40 / stopper patience 80 / 1000 iters, grid search)
and ``experiments/mag/configs.py`` (optimized EGConv net, 200 iters,
patience 50, fixed hparams, checkpointing disabled).

The whole graph lives on device; split indices become static
boolean masks; the epoch == one jitted step.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from egc_tpu.graph.structure import Graph, pad_graph
from egc_tpu.data import synthetic
from egc_tpu.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu.exp.hyperparams import (
    LogUniformHyperParam, UniformHyperParam,
)
from egc_tpu.models.nets import ConvSpec, ArxivNet, MagNet
from egc_tpu.nn.conv.pna import avg_log_degree
from egc_tpu.train.loop import make_train_step, make_eval_step
from egc_tpu.train.optim import plateau_init
from egc_tpu.train.state import TrainState


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def full_graph_to_device_dict(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Pad a host full-graph dict (one padding row, 128-multiple edge
    budget), precompute the global symnorm weights and build the split
    masks; returns device arrays."""
    from egc_tpu.graph.transforms import symnorm_weight as _symw

    n = raw["x"].shape[0]
    # global symnorm weights (the transductive cache)
    ew, sw = _symw(jnp.asarray(raw["senders"]), jnp.asarray(raw["receivers"]),
                   n)
    g = Graph.from_coo(raw["x"], raw["senders"], raw["receivers"])
    g = g.replace(edge_weight=np.asarray(ew), self_weight=np.asarray(sw))
    g = pad_graph(g, num_nodes=_round_up(n + 1, 8),
                  num_edges=_round_up(len(raw["senders"]), 128))
    npad = g.num_nodes
    y = np.zeros((npad,), np.int32)
    y[:n] = raw["y"]
    masks = {}
    for split in ("train", "val", "test"):
        m = np.zeros((npad,), bool)
        m[raw[f"{split}_idx"]] = True
        masks[split] = m
    deg = np.zeros(n, np.int64)
    np.add.at(deg, raw["receivers"], 1)
    return {
        "graph": jax.tree.map(jnp.asarray, g),
        "y": jnp.asarray(y),
        "masks": {k: jnp.asarray(v) for k, v in masks.items()},
        "num_classes": raw["num_classes"],
        "avg_log_deg": avg_log_degree(np.bincount(deg)),
    }


class FullGraphConfig(ExperimentConfig):
    """Shared machinery for transductive node classification."""

    num_layers: int = 3

    def __init__(self, model_kind: str, hidden: int, *, heads: int = 8,
                 bases: int = 8, softmax: bool = False,
                 aggrs: Optional[Tuple[str, ...]] = None,
                 gat_version: int = 1):
        self.model_kind = model_kind
        self.hidden = hidden
        self.heads = heads
        self.bases = bases
        self.softmax = softmax
        self.aggrs = tuple(aggrs) if aggrs else None
        self.gat_version = gat_version
        self._train_step = None
        self._eval_step = None
        self._avg_log_deg = 1.0

    def load_full_graph(self) -> Dict[str, Any]:
        raise NotImplementedError

    def data(self, hparams):
        d = full_graph_to_device_dict(self.load_full_graph())
        self._avg_log_deg = d["avg_log_deg"]
        return d

    def conv_spec(self) -> ConvSpec:
        kind = self.model_kind
        if kind in ("gat", "gatv2"):
            kind = "gat" if self.gat_version == 1 else "gatv2"
        return ConvSpec(kind=kind, heads=self.heads, bases=self.bases,
                        softmax=self.softmax, aggrs=self.aggrs,
                        avg_log_deg=self._avg_log_deg)

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        variables = jax.jit(model.init, static_argnames=("train",))(
            self.rng(seed), data["graph"], train=False)
        return TrainState.create(params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 tx=self.optimizer(hparams))

    def loss_fn(self, out, y, graph):
        from egc_tpu.train.losses import gather_label_scores
        labels, train_mask = y
        nll = -gather_label_scores(out, labels)
        m = train_mask.astype(out.dtype)
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    def _steps(self, model):
        # keyed by the model (a frozen dataclass): hyperparameters that
        # change model fields (e.g. dropout) must rebuild the jitted steps
        cache = getattr(self, "_steps_cache", None)
        if cache is None:
            cache = self._steps_cache = {}
        if model not in cache:
            cache[model] = (make_train_step(model, self.loss_fn),
                            make_eval_step(model))
        return cache[model]

    def train(self, model, state, data, rng, iteration: int):
        step, _ = self._steps(model)
        state, loss = step(state, data["graph"],
                           (data["y"], data["masks"]["train"]),
                           jax.random.fold_in(rng, iteration))
        return state, {"train_loss": float(loss)}

    def val(self, model, state, data):
        from egc_tpu.train.metrics import split_accuracies
        _, eval_step = self._steps(model)
        out = eval_step(state, data["graph"])
        return split_accuracies(out, data["y"], data["masks"])

    def test(self, model, state, data):
        return self.val(model, state, data)


class ArxivConfig(FullGraphConfig):
    name = "arxiv"
    num_layers = 3                     # reference arxiv/configs.py:29

    def settings(self):
        return ExperimentSettings("arxiv", final_repeats=10,
                                  final_max_iterations=1000)

    def stoppers(self):
        return StopperSpec(patience=80, max_iters=1000)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        # reference arxiv/configs.py:122-123 (FIFO scheduler = no pruner)
        from egc_tpu.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 10, "wd": 2, "dropout": 2})

    def hyperparams(self):
        # reference arxiv/configs.py:140-144
        return {
            "lr": LogUniformHyperParam(0.001, 0.05, default=0.01),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
            "dropout": UniformHyperParam(0.0, 0.2, default=0.2),
        }

    def plateau(self, hparams):
        # ReduceLROnPlateau(patience=40): reference arxiv/configs.py:153-157
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=40, min_lr=1e-5)

    def load_full_graph(self):
        if self.synthetic:
            return synthetic.synthetic_full_graph(
                num_nodes=4000, avg_degree=12, num_classes=40,
                num_features=128)
        from egc_tpu.data.ondisk import load_ogbn_arxiv
        return load_ogbn_arxiv()

    def model(self, hparams):
        return ArxivNet(conv=self.conv_spec(), hidden_dim=self.hidden,
                        num_layers=self.num_layers,
                        dropout=float(hparams.get("dropout", 0.2)),
                        residual=True)


class MagConfig(FullGraphConfig):
    """Homogeneous ogbn-mag (paper-cites-paper) with the optimized EGConv
    net; fixed hyperparameters (empty grid, reference mag/configs.py:108-109).
    """

    name = "mag"
    num_layers = 2                     # reference mag/configs.py:25

    def settings(self):
        return ExperimentSettings("mag", final_repeats=10,
                                  final_max_iterations=200,
                                  checkpoint_at_end=False)

    def stoppers(self):
        return StopperSpec(patience=50, max_iters=200)

    def trial_metric(self):
        return Metric("val_acc", "max")

    def search_strategy(self):
        # fixed hparams: empty grid (reference mag/configs.py:108-109)
        from egc_tpu.exp.search import GridSearchStrategy
        return GridSearchStrategy({})

    def hyperparams(self):
        return {
            "lr": LogUniformHyperParam(0.001, 0.05, default=0.01),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0),
            "dropout": UniformHyperParam(0.0, 0.5, default=0.5),
        }

    def plateau(self, hparams):
        # ReduceLROnPlateau(patience=10): reference mag/configs.py:140-142
        return plateau_init(hparams["lr"], mode="max", factor=0.5,
                            patience=10, min_lr=1e-5)

    def load_full_graph(self):
        if self.synthetic:
            return synthetic.synthetic_full_graph(
                num_nodes=6000, avg_degree=10, num_classes=349,
                num_features=128)
        from egc_tpu.data.ondisk import load_ogbn_mag_homogeneous
        return load_ogbn_mag_homogeneous()

    def model(self, hparams):
        return MagNet(hidden_dim=self.hidden, num_layers=self.num_layers,
                      dropout=float(hparams.get("dropout", 0.5)),
                      heads=self.heads, bases=self.bases,
                      aggrs=self.aggrs or ("symnorm",))


class PartitionedArxivConfig(ArxivConfig):
    """Arxiv trained across a ``graph`` mesh axis: nodes partitioned with
    halo exchange per layer (egc_tpu.parallel.halo). Same hook surface as
    ArxivConfig; requires ``partitions`` devices. Numerics equal the
    single-device config exactly (sync-BN + global symnorm weights +
    psum'd loss; see tests/test_partition.py)."""

    def __init__(self, *args, partitions: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        import jax as _jax

        self.partitions = partitions or _jax.device_count()
        self._mesh = None
        self._pstep = None

    def data(self, hparams):
        from egc_tpu.graph.transforms import symnorm_weight
        from egc_tpu.parallel import make_mesh, partition_graph

        raw = self.load_full_graph()
        n = raw["x"].shape[0]
        self._avg_log_deg = 1.0
        ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                                jnp.asarray(raw["receivers"]), n)
        plan = partition_graph(raw["senders"], raw["receivers"], n,
                               self.partitions, method="bfs",
                               sym_edge_w=np.asarray(ew),
                               sym_self_w=np.asarray(sw))
        x_ext = np.zeros((self.partitions, plan.n_ext, raw["x"].shape[1]),
                         np.float32)
        x_ext[:, :plan.n_local] = plan.scatter_nodes(raw["x"])
        self._mesh = make_mesh({"graph": self.partitions})
        # every per-partition array lives on its partition's device
        shard = partial(jax.device_put, device=NamedSharding(
            self._mesh, PartitionSpec("graph")))
        masks = {}
        for split in ("train", "val", "test"):
            m = np.zeros(n, bool)
            m[raw[f"{split}_idx"]] = True
            masks[split] = shard(plan.scatter_nodes(m))
        data = {
            "plan": plan,
            "graph": jax.tree.map(shard, plan.extended_graph(x_ext)),
            "send_idx": shard(plan.send_idx),
            "y": shard(plan.scatter_nodes(raw["y"])),
            "masks": masks,
            "num_classes": raw["num_classes"],
            "num_features": raw["x"].shape[1],
        }
        # record immediately so model(hparams) built after data() (run_trial
        # and restore_trial ordering) sees the real feature/class counts
        self._last_pdata = data
        return data

    def model(self, hparams):
        from egc_tpu.parallel import DistributedNodeClassifier

        data = getattr(self, "_last_pdata", None)
        nfeat = data["num_features"] if data else 128
        ncls = data["num_classes"] if data else 40
        e_int = data["plan"].e_interior if data else None
        return DistributedNodeClassifier(
            conv=self.conv_spec(), hidden_dim=self.hidden,
            num_layers=self.num_layers,
            dropout=float(hparams.get("dropout", 0.2)), residual=True,
            num_features=nfeat, num_classes=ncls, e_interior=e_int)

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        from egc_tpu.parallel import init_partitioned

        self._last_pdata = data
        model = self.model(hparams)   # rebuild with data metadata
        self._model_obj = model
        variables = init_partitioned(
            model, self._mesh, data["graph"], data["send_idx"],
            self.rng(seed))
        return TrainState.create(params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 tx=self.optimizer(hparams))

    def train(self, model, state, data, rng, iteration: int):
        from egc_tpu.parallel import make_partitioned_train_step

        model = getattr(self, "_model_obj", model)
        if self._pstep is None or self._pstep_model != model:
            self._pstep = make_partitioned_train_step(model, self._mesh)
            self._pstep_model = model
        state, loss = self._pstep(
            state, data["graph"], data["send_idx"], data["y"],
            data["masks"]["train"], jax.random.fold_in(rng, iteration))
        return state, {"train_loss": float(loss)}

    def val(self, model, state, data):
        from egc_tpu.parallel import make_partitioned_eval_step

        model = getattr(self, "_model_obj", model)
        if self._eval_step is None or \
                getattr(self, "_eval_model", None) != model:
            self._eval_step = make_partitioned_eval_step(model, self._mesh)
            self._eval_model = model
        out = self._eval_step(state, data["graph"], data["send_idx"])
        from egc_tpu.train.metrics import split_accuracies
        plan = data["plan"]
        return split_accuracies(out[:, :plan.n_local], data["y"],
                                data["masks"])


class SampledMagConfig(MagConfig):
    """ogbn-mag (homogeneous) trained on neighbor-sampled mini-batches
    instead of the full graph — the MAG-scale path (BASELINE: "EGC-M on
    ogbn-mag, neighbor-sampled"). Seeds shard naturally across devices for
    sampling-parallel DP training.

    Training uses the sampled-subgraph symnorm estimator (standard
    GraphSAGE-style); EVALUATION runs a deterministic full-graph forward
    (no sampling), matching the reference's full-graph metric protocol
    (reference mag/configs.py:34) — so val/test/train accuracies are exact,
    not stochastic estimates.
    """

    def __init__(self, *args, fanouts=(15, 10), batch_size: int = 512,
                 device_sampler: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        # device_sampler: the layered neighbor sample runs as jax INSIDE
        # the jitted train step (data/device_sampling.py) — one device
        # call per batch, host contributes only the shuffled seed stream
        self.device_sampler = device_sampler

    def _eval_data(self, raw):
        """Deterministic full-graph eval dict (reference metric protocol,
        mag/configs.py:34) — shared by the host- and device-sampler
        branches."""
        self._avg_log_deg = 1.0
        return {"num_classes": raw["num_classes"],
                "x_full": jnp.asarray(raw["x"]),
                "full": full_graph_to_device_dict(raw)}

    def data(self, hparams):
        from egc_tpu.data.sampling import NeighborSampler, SampledNodeLoader

        raw = self.load_full_graph()
        n = raw["x"].shape[0]
        if self.device_sampler:
            from egc_tpu.data.device_sampling import DeviceNeighborSampler

            dsampler = DeviceNeighborSampler(
                raw["senders"], raw["receivers"], n, fanouts=self.fanouts)
            out = self._eval_data(raw)
            out.update(
                dsampler=dsampler,
                seed_ids={s: np.asarray(raw[f"{s}_idx"])
                          for s in ("train", "val", "test")},
                y_full=jnp.asarray(raw["y"]))
            return out
        sampler = NeighborSampler(raw["senders"], raw["receivers"], n,
                                  fanouts=self.fanouts)
        # Feature rows are gathered ON DEVICE from the resident full
        # matrix — the per-batch transfer is the gid list, not the
        # gathered features — and prefetch threads overlap the host
        # sampling with device steps (on the CPU backend the "device" is
        # the host, so threads would only compete with it).
        prefetch = 0 if jax.default_backend() == "cpu" else 4
        loaders = {}
        for split in ("train", "val", "test"):
            import zlib
            loaders[split] = SampledNodeLoader(
                sampler, raw["x"], raw["y"], raw[f"{split}_idx"],
                self.batch_size, shuffle=(split == "train"),
                rng_seed=zlib.crc32(split.encode()) % (2 ** 31),
                prefetch=prefetch,
                gather_on_device=True)
        out = self._eval_data(raw)
        out["loaders"] = loaders
        return out

    def _sampled_steps(self, model):
        cache = getattr(self, "_sampled_cache", None)
        if cache is None:
            cache = self._sampled_cache = {}
        if model not in cache:
            loss_fn = self.loss_fn

            @jax.jit
            def step(state, graph, gids, x_full, y, rng):
                graph = graph.replace(
                    nodes=jnp.take(x_full, gids, axis=0))

                def loss_wrapped(params):
                    out, mutated = model.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        graph, train=True, rngs={"dropout": rng},
                        mutable=["batch_stats"])
                    return loss_fn(out, y, graph), \
                        mutated.get("batch_stats", state.batch_stats)

                (loss, bs), grads = jax.value_and_grad(
                    loss_wrapped, has_aux=True)(state.params)
                return state.apply_gradients(grads, new_batch_stats=bs), loss

            cache[model] = step
        return cache[model]

    def _device_sampled_step(self, model, dsampler):
        cache = getattr(self, "_dev_sampled_cache", None)
        if cache is None:
            cache = self._dev_sampled_cache = {}
        # key by VALUES, not sampler identity: run_trial rebuilds the
        # sampler per trial, and the step closure depends only on these
        # (CSR arrays are step ARGUMENTS) — identity keying would
        # recompile the identical step every final-repeat trial
        key = (model, dsampler.num_nodes, dsampler.fanouts,
               self.batch_size)
        if key not in cache:
            from egc_tpu.data import device_sampling as dsmod

            sample_raw = dsampler.raw(self.batch_size)
            loss_fn = self.loss_fn
            n = dsampler.num_nodes

            @jax.jit
            def step(state, seeds, rng, rowptr, in_senders, x_full,
                     y_full):
                gids, s, r, em, nm, _ = sample_raw(rng, seeds, rowptr,
                                                   in_senders)
                gidc = jnp.minimum(gids, n - 1)
                nodes = jnp.where(nm[:, None],
                                  jnp.take(x_full, gidc, axis=0), 0.0)
                graph = dsmod.as_graph(gids, s, r, em, nm).replace(
                    nodes=nodes)
                yb = jnp.take(y_full, gidc)
                seed_mask = (jnp.arange(nm.shape[0]) <
                             self.batch_size) & nm

                def loss_wrapped(params):
                    out, mutated = model.apply(
                        {"params": params,
                         "batch_stats": state.batch_stats},
                        graph, train=True, rngs={"dropout": rng},
                        mutable=["batch_stats"])
                    return loss_fn(out, (yb, seed_mask), graph), \
                        mutated.get("batch_stats", state.batch_stats)

                (loss, bs), grads = jax.value_and_grad(
                    loss_wrapped, has_aux=True)(state.params)
                return state.apply_gradients(grads, new_batch_stats=bs), \
                    loss

            cache[key] = step
        return cache[key]

    def _device_seed_batches(self, data, rng_np):
        n = data["dsampler"].num_nodes
        order = np.array(data["seed_ids"]["train"])
        rng_np.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            seeds = np.full(self.batch_size, n, np.int32)
            seeds[:len(chunk)] = chunk
            yield jnp.asarray(seeds)

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        if self.device_sampler:
            ds = data["dsampler"]
            g, gids = ds.sample_graph(
                jax.random.key(0),
                jnp.asarray(np.asarray(
                    data["seed_ids"]["val"][:self.batch_size],
                    np.int32)))
            n = ds.num_nodes
            g = g.replace(nodes=jnp.take(
                data["x_full"], jnp.minimum(gids, n - 1), axis=0))
        else:
            g, _, _, gids = next(iter(data["loaders"]["val"]))
            g = jax.tree.map(jnp.asarray, g)
            g = g.replace(nodes=jnp.take(data["x_full"], jnp.asarray(gids),
                                         axis=0))
        variables = jax.jit(model.init, static_argnames=("train",))(
            self.rng(seed), g, train=False)
        return TrainState.create(params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 tx=self.optimizer(hparams))

    def train(self, model, state, data, rng, iteration: int):
        if self.device_sampler:
            step = self._device_sampled_step(model, data["dsampler"])
            rowptr, in_senders = data["dsampler"].csr
            # deterministic per-trial shuffle (hash() is process-salted)
            rng_np = np.random.default_rng(int(jax.random.randint(
                jax.random.fold_in(rng, iteration), (), 0, 2 ** 31 - 1)))
            losses = []
            for i, seeds in enumerate(
                    self._device_seed_batches(data, rng_np)):
                state, loss = step(
                    state, seeds,
                    jax.random.fold_in(jax.random.fold_in(rng, iteration),
                                       i),
                    rowptr, in_senders, data["x_full"], data["y_full"])
                losses.append(loss)
            mean = float(jnp.mean(jnp.stack(losses))) if losses else 0.0
            return state, {"train_loss": mean}
        step = self._sampled_steps(model)
        losses = []     # device-side until epoch end (keep dispatch async)
        for i, (g, yb, seed_mask, gids) in enumerate(
                data["loaders"]["train"]):
            g = jax.tree.map(jnp.asarray, g)
            state, loss = step(
                state, g, jnp.asarray(gids), data["x_full"],
                (jnp.asarray(yb), jnp.asarray(seed_mask)),
                jax.random.fold_in(jax.random.fold_in(rng, iteration), i))
            losses.append(loss)
        mean = float(jnp.mean(jnp.stack(losses))) if losses else 0.0
        return state, {"train_loss": mean}

    def val(self, model, state, data):
        # full-graph deterministic evaluation (reference mag/configs.py:34);
        # the conv layers are graph-generic, so the sampled-trained params
        # apply directly to the full graph
        from egc_tpu.train.metrics import split_accuracies
        _, eval_step = self._steps(model)
        full = data["full"]
        out = eval_step(state, full["graph"])
        return split_accuracies(out, full["y"], full["masks"])
