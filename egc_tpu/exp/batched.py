"""Experiment configs for the batched mini-graph tasks: zinc / cifar /
molhiv / code.

Reference counterparts: ``experiments/zinc/configs.py``,
``experiments/cifar/configs.py``, ``experiments/mol/configs.py``,
``experiments/code/configs.py``. Hyperparameter spaces and training recipes
(Adam + ReduceLROnPlateau + patient stopping) mirrored; datasets come from
the synthetic generators in this no-egress environment (on-disk readers are
used automatically when real data is present).
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from egc_tpu.data.loaders import GraphLoader, padding_budget
from egc_tpu.data import synthetic
from egc_tpu.exp.config import (
    ExperimentConfig, ExperimentSettings, Metric, StopperSpec,
)
from egc_tpu.exp.hyperparams import (
    ChoiceHyperParam, LogUniformHyperParam, UniformHyperParam,
)
from egc_tpu.models.nets import (
    ConvSpec, ZincNet, CifarNet, HIVNet, CodeNet,
)
from egc_tpu.train.loop import (
    make_train_step, make_eval_step, train_epoch, eval_epoch,
)
from egc_tpu.train.metrics import roc_auc, sequence_f1
from egc_tpu.train.state import TrainState


def _masked_mean(values, mask):
    m = mask.astype(values.dtype)
    return jnp.sum(values * m) / jnp.maximum(jnp.sum(m), 1.0)


class BatchedGraphConfig(ExperimentConfig):
    """Shared machinery for the padded-batch graph-level tasks."""

    def __init__(self, model_kind: str, hidden: int, *, heads: int = 8,
                 bases: int = 4, softmax: bool = False, sigmoid: bool = False,
                 hardtanh: bool = False, aggrs: Optional[Tuple[str, ...]] = None,
                 num_layers: int = 4, readout: str = "mean",
                 avg_log_deg: float = 1.0):
        self.model_kind = model_kind
        self.hidden = hidden
        self.conv = ConvSpec(
            kind=model_kind, heads=heads, bases=bases, softmax=softmax,
            sigmoid=sigmoid, hardtanh=hardtanh,
            aggrs=tuple(aggrs) if aggrs else None,
            avg_log_deg=avg_log_deg)
        self.num_layers = num_layers
        self.readout = readout
        self._train_step = None
        self._eval_step = None

    # -- hooks for subclasses ---------------------------------------------
    def load_graphs(self) -> Dict[str, list]:
        raise NotImplementedError

    def loss_fn(self, out, y, graph):
        raise NotImplementedError

    def eval_metrics(self, collected, split: str) -> Dict[str, float]:
        raise NotImplementedError

    # -- shared implementation --------------------------------------------
    def hyperparams(self):
        # reference zinc/configs.py:194-199 (same space reused per task)
        return {
            "lr": LogUniformHyperParam(0.0001, 0.01, default=0.001),
            "batch_size": ChoiceHyperParam([64, 128], default=128),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
        }

    def trial_metric(self) -> Metric:
        return Metric("val_loss", "min")

    def _ahb(self, grace_period: int, max_t: int):
        from egc_tpu.exp.search import AsyncHyperBandPruner
        return AsyncHyperBandPruner(self.trial_metric().mode,
                                    grace_period=grace_period, max_t=max_t)

    def trial_scheduler(self):
        # reference zinc/cifar configs: AsyncHyperBand grace_period=20
        return self._ahb(20, self.settings().final_max_iterations)

    def data(self, hparams):
        splits = self.load_graphs()
        bs = int(hparams.get("batch_size", 128))
        all_graphs = splits["train"] + splits["val"] + splits["test"]
        budget = padding_budget(all_graphs, bs)
        # prefetch threads overlap host batching with the device step (on
        # the CPU backend they would only compete with it)
        prefetch = 0 if jax.default_backend() == "cpu" else 4
        # crc32, not hash(): Python string hashing is randomized per process
        # (PYTHONHASHSEED), which would break seeded-run reproducibility
        return {
            name: GraphLoader(graphs, bs, shuffle=(name == "train"),
                              budget=budget, prefetch=prefetch,
                              seed=zlib.crc32(name.encode()) % (2 ** 31))
            for name, graphs in splits.items()
        }

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        graph, _ = next(iter(data["val"]))
        graph = jax.tree.map(jnp.asarray, graph)
        variables = jax.jit(model.init, static_argnames=("train",))(
            self.rng(seed), graph, train=False)
        tx = self.optimizer(hparams)
        return TrainState.create(params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 tx=tx)

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
        state, loss = train_epoch(step, state, data["train"],
                                  jax.random.fold_in(rng, iteration))
        return state, {"train_loss": loss}

    def _evaluate(self, model, state, data, split: str):
        _, eval_step = self._steps(model)
        collected = eval_epoch(eval_step, state, data[split])
        return self.eval_metrics(collected, split)

    def val(self, model, state, data):
        return self._evaluate(model, state, data, "val")

    def test(self, model, state, data):
        return self._evaluate(model, state, data, "test")


class ZincConfig(BatchedGraphConfig):
    """Graph regression, L1/MAE (reference experiments/zinc/configs.py)."""

    name = "zinc"

    def settings(self):
        return ExperimentSettings("zinc", final_repeats=10,
                                  final_max_iterations=200)

    def stoppers(self):
        return StopperSpec(patience=20, max_iters=200)

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu.data.ondisk import load_zinc
            return load_zinc()
        return synthetic.synthetic_zinc()

    def model(self, hparams):
        return ZincNet(conv=self.conv, hidden_dim=self.hidden,
                       num_layers=self.num_layers, in_feat_drop=0.0,
                       residual=True, readout=self.readout)

    def loss_fn(self, out, y, graph):
        err = jnp.abs(out.reshape(-1) - y.reshape(-1).astype(out.dtype))
        return _masked_mean(err, graph.graph_mask)

    def eval_metrics(self, collected, split):
        errs, cnt = 0.0, 0.0
        for out, y, mask in collected:
            e = np.abs(np.asarray(out).reshape(-1) - y.reshape(-1))
            errs += float((e * mask).sum())
            cnt += float(mask.sum())
        return {f"{split}_loss": errs / max(cnt, 1.0)}


class CifarConfig(BatchedGraphConfig):
    """10-class graph classification (reference experiments/cifar/configs.py).

    Adds a tuned dropout hyperparameter applied before each conv."""

    name = "cifar"

    def __init__(self, *args, dropout: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.dropout = dropout

    def settings(self):
        return ExperimentSettings("cifar", final_repeats=10,
                                  final_max_iterations=200)

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu.data.ondisk import load_cifar10_superpixels
            return load_cifar10_superpixels()
        return synthetic.synthetic_cifar()

    def model(self, hparams):
        return CifarNet(conv=self.conv, hidden_dim=self.hidden,
                        num_layers=self.num_layers,
                        dropout=float(hparams.get("dropout", self.dropout)),
                        residual=True, readout=self.readout)

    def hyperparams(self):
        hp = super().hyperparams()
        # reference cifar/configs.py:145
        hp["dropout"] = UniformHyperParam(0.0, 0.5, default=0.0)
        return hp

    def loss_fn(self, out, y, graph):
        ce = optax.softmax_cross_entropy_with_integer_labels(
            out, y.reshape(-1))
        return _masked_mean(ce, graph.graph_mask)

    def eval_metrics(self, collected, split):
        ce_sum, cnt, correct = 0.0, 0.0, 0.0
        for out, y, mask in collected:
            out = np.asarray(out)
            y = y.reshape(-1)
            logp = out - np.log(np.exp(out - out.max(-1, keepdims=True)).sum(
                -1, keepdims=True)) - out.max(-1, keepdims=True)
            ce = -np.take_along_axis(logp, y[:, None].astype(np.int64),
                                     axis=1).reshape(-1)
            ce_sum += float((ce * mask).sum())
            correct += float(((out.argmax(-1) == y) * mask).sum())
            cnt += float(mask.sum())
        return {f"{split}_loss": ce_sum / max(cnt, 1.0),
                f"{split}_metric": correct / max(cnt, 1.0)}


class MolConfig(BatchedGraphConfig):
    """ogbg-molhiv: BCE-with-logits + ROC-AUC (reference
    experiments/mol/configs.py:64-107)."""

    name = "hiv"

    def settings(self):
        return ExperimentSettings("hiv", final_repeats=10,
                                  final_max_iterations=100)

    def trial_metric(self):
        return Metric("val_metric", "max")

    def search_strategy(self):
        # reference mol/configs.py:125-126
        from egc_tpu.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 5, "wd": 2, "dropout": 2})

    def trial_scheduler(self):
        # reference mol/configs.py:128-131: grace_period=30
        return self._ahb(30, self.settings().final_max_iterations)

    def hyperparams(self):
        # reference mol/configs.py:162-167
        return {
            "lr": LogUniformHyperParam(0.0001, 0.01, default=0.001),
            "batch_size": ChoiceHyperParam([32, 64], default=32),
            "wd": LogUniformHyperParam(0.0001, 0.001, default=0.0005),
            "dropout": UniformHyperParam(0.0, 0.2, default=0.2),
        }

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu.data.ondisk import load_ogbg_molhiv
            return load_ogbg_molhiv()
        return synthetic.synthetic_molhiv()

    def model(self, hparams):
        # dropout hparam feeds in_feat_drop (reference mol/configs.py:249)
        return HIVNet(conv=self.conv, hidden_dim=self.hidden,
                      num_layers=self.num_layers,
                      in_feat_drop=float(hparams.get("dropout", 0.2)),
                      residual=True, readout=self.readout)

    def loss_fn(self, out, y, graph):
        y = y.reshape(-1).astype(out.dtype)
        logits = out.reshape(-1)
        # mask unlabeled targets (OGB convention: label < 0 means missing;
        # reference masks with y == y, mol/configs.py:64-68)
        labeled = (y >= 0) & graph.graph_mask
        bce = optax.sigmoid_binary_cross_entropy(logits, y)
        return _masked_mean(bce, labeled)

    def eval_metrics(self, collected, split):
        scores, labels = [], []
        for out, y, mask in collected:
            m = mask.astype(bool)
            scores.append(np.asarray(out).reshape(-1)[m])
            labels.append(y.reshape(-1)[m])
        return {f"{split}_metric": roc_auc(np.concatenate(scores),
                                           np.concatenate(labels))}


class CodeConfig(BatchedGraphConfig):
    """ogbg-code2: 5-token decode, mean CE, sequence F1 (reference
    experiments/code/configs.py:55-106)."""

    name = "code"

    def __init__(self, *args, vocab_size: int = None,
                 use_old_code_dataset: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        # real ogbg-code2 uses the top-5000 vocab (reference
        # code/utils.py:11); the synthetic stand-in uses a small one
        self._vocab_size = vocab_size
        # old ogbg-code has 10003 node attributes vs code2's 10030
        # (reference code/utils.py:14-15)
        self.use_old_code_dataset = use_old_code_dataset

    def settings(self):
        # ITERS=25 (reference code/configs.py:28)
        return ExperimentSettings("code", final_repeats=10,
                                  final_max_iterations=25)

    def stoppers(self):
        # PATIENCE=5 (reference code/configs.py:29,144-146)
        return StopperSpec(patience=5, max_iters=25)

    def trial_metric(self):
        return Metric("val_metric", "max")

    def search_strategy(self):
        # reference code/configs.py:128-129
        from egc_tpu.exp.search import GridSearchStrategy
        return GridSearchStrategy({"lr": 6})

    def trial_scheduler(self):
        # reference code/configs.py:131-135: grace_period=15
        return self._ahb(15, 25)

    def hyperparams(self):
        # lr is the only searched hyperparameter; batch size is fixed 128
        # (reference code/configs.py:160-163,141)
        return {
            "lr": LogUniformHyperParam(0.0001, 0.01, default=0.001),
        }

    def plateau(self, hparams):
        # ReduceLROnPlateau(mode=max, factor=0.2, patience=10):
        # reference code/configs.py:155-157
        from egc_tpu.train.optim import plateau_init
        return plateau_init(hparams["lr"], mode="max", factor=0.2,
                            patience=10, min_lr=1e-5)

    @property
    def vocab_size(self):
        if self._vocab_size is not None:
            return self._vocab_size
        return 120 if self.synthetic else 5000

    def load_graphs(self):
        if not self.synthetic:
            from egc_tpu.data.ondisk import load_ogbg_code2
            d = load_ogbg_code2(num_vocab=self.vocab_size)
            self.idx2vocab = d["idx2vocab"]
            return d["splits"]
        return synthetic.synthetic_code(vocab_size=self.vocab_size)

    def model(self, hparams):
        n_attr = 500 if self.synthetic else \
            (10003 if self.use_old_code_dataset else 10030)
        return CodeNet(conv=self.conv, hidden_dim=self.hidden,
                       num_layers=self.num_layers, in_feat_drop=0.0,
                       residual=True, readout=self.readout,
                       vocab_size=self.vocab_size, num_nodeattributes=n_attr)

    def loss_fn(self, out, y, graph):
        # out: [G, S, V]; y: [G, S]. Mean CE over the S independent heads
        # (reference code/configs.py:62-66).
        ce = optax.softmax_cross_entropy_with_integer_labels(out, y)
        return _masked_mean(ce.mean(-1), graph.graph_mask)

    def eval_metrics(self, collected, split):
        preds, refs = [], []
        eos = self.vocab_size + 1

        def cut(seq):
            # cut at the FIRST __EOS__ (reference decode_arr_to_seq,
            # code/utils.py:19-28)
            out = []
            for t in seq:
                if t == eos:
                    break
                out.append(int(t))
            return out

        for out, y, mask in collected:
            tok = np.asarray(out).argmax(-1)        # [G, S]
            for i in np.where(mask)[0]:
                preds.append(cut(tok[i]))
                refs.append(cut(y[i]))
        return {f"{split}_metric": sequence_f1(preds, refs)}
