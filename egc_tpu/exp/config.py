"""ExperimentConfig — the hook surface every task implements.

Mirrors the reference's exptune ``ExperimentConfig`` contract (inferred API,
SURVEY §2.2; reference call sites ``experiments/zinc/configs.py:93-186``)
without Ray: data / model / optimizer / train / val / test / persist_trial /
restore_trial / hyperparams / settings / trial_metric / stoppers.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Tuple

import jax
import numpy as np

from egc_tpu.exp.hyperparams import HyperParam, default_hparams
from egc_tpu.train.optim import (
    PlateauState, plateau_init, plateau_update, make_optimizer, set_lr,
)
from egc_tpu.train.state import TrainState
from egc_tpu.train.checkpoint import save_checkpoint, load_checkpoint


@dataclasses.dataclass(frozen=True)
class ExperimentSettings:
    name: str
    final_repeats: int = 10
    final_max_iterations: int = 200
    checkpoint_at_end: bool = True
    checkpoint_freq: int = 0


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    mode: str  # "min" | "max"


@dataclasses.dataclass(frozen=True)
class StopperSpec:
    patience: int
    max_iters: int


@dataclasses.dataclass(frozen=True)
class TrialResources:
    """Per-trial resource request (exptune surface parity, reference
    zinc/configs.py:106). Accelerators are not fractionally shared the way
    the reference packs fractional GPUs; ``cpus`` maps to parallel-search
    worker processes and ``chips`` to whole devices per trial."""

    cpus: int = 1
    chips: float = 1.0


class ExperimentConfig:
    """Base class; subclasses implement the task-specific hooks."""

    synthetic: bool = True   # no-egress environment default

    # ---- experiment description -----------------------------------------
    def settings(self) -> ExperimentSettings:
        raise NotImplementedError

    def trial_metric(self) -> Metric:
        raise NotImplementedError

    def stoppers(self) -> StopperSpec:
        s = self.settings()
        return StopperSpec(patience=20, max_iters=s.final_max_iterations)

    def hyperparams(self) -> Dict[str, HyperParam]:
        raise NotImplementedError

    def default_hparams(self) -> Dict[str, Any]:
        return default_hparams(self.hyperparams())

    def search_strategy(self):
        """Search strategy for this task (reference zinc/configs.py:108-109).
        Default: random search over ``num_samples`` candidates."""
        from egc_tpu.exp.search import RandomSearchStrategy
        return RandomSearchStrategy(getattr(self, "_num_samples", 50))

    def trial_scheduler(self):
        """Pruner for the search, or None for FIFO (run every trial to
        stop/patience). Reference: AsyncHyperBandScheduler vs FIFOScheduler
        per task (SURVEY §2.2)."""
        return None

    def resource_requirements(self) -> "TrialResources":
        """Per-trial resources; ``cpus`` bounds parallel-search workers
        (reference zinc/configs.py:105-106)."""
        return TrialResources(cpus=1, chips=1.0)

    # ---- construction ----------------------------------------------------
    def data(self, hparams: Dict[str, Any]):
        raise NotImplementedError

    def model(self, hparams: Dict[str, Any]):
        raise NotImplementedError

    def optimizer(self, hparams: Dict[str, Any]):
        """torch Adam(lr, wd) parity (reference zinc/configs.py:128-129)."""
        return make_optimizer(hparams["lr"], hparams.get("wd", 0.0))

    def plateau(self, hparams) -> PlateauState:
        metric = self.trial_metric()
        return plateau_init(hparams["lr"], mode=metric.mode, factor=0.5,
                            patience=10, min_lr=1e-5)

    def init_state(self, model, hparams, data, seed: int) -> TrainState:
        raise NotImplementedError

    # ---- one iteration ---------------------------------------------------
    def train(self, model, state, data, rng, iteration: int):
        """-> (state, {"train_loss": ...})"""
        raise NotImplementedError

    def val(self, model, state, data) -> Dict[str, float]:
        raise NotImplementedError

    def test(self, model, state, data) -> Dict[str, float]:
        raise NotImplementedError

    def apply_plateau(self, state, plateau: PlateauState,
                      val_metrics) -> Tuple[TrainState, PlateauState]:
        """lr_scheduler.step(val_metric) (reference zinc/configs.py:147-151)."""
        metric = self.trial_metric()
        new_plateau = plateau_update(plateau, float(val_metrics[metric.name]))
        if new_plateau.lr != plateau.lr:
            state = state.replace(opt_state=set_lr(state.opt_state,
                                                   new_plateau.lr))
        return state, new_plateau

    # ---- persistence -----------------------------------------------------
    def persist_trial(self, ckpt_dir, state, plateau, hparams, extra=None):
        save_checkpoint(Path(ckpt_dir), state=state, plateau=plateau,
                        hparams=hparams, extra=extra)

    def restore_trial(self, ckpt_dir, data=None, seed: int = 0):
        import json
        meta = json.loads((Path(ckpt_dir) / "checkpoint.json").read_text())
        hparams = meta.get("hparams", {})
        # data BEFORE model, mirroring run_trial: data-dependent model fields
        # (e.g. PNA's avg_log_deg) must see the dataset statistics.
        if data is None:
            data = self.data(hparams)
        model = self.model(hparams)
        template = self.init_state(model, hparams, data, seed)
        state, plateau, _ = load_checkpoint(Path(ckpt_dir),
                                            state_template=template)
        return model, state, plateau, hparams, data

    def final_runs_summaries(self):
        """Summary objects applied after final repeats (reference
        zinc/configs.py:182-186)."""
        from egc_tpu.exp.summaries import TrialCurvePlotter, \
            TestMetricSummaries
        metric = self.trial_metric()
        return [TrialCurvePlotter(["train_loss", metric.name],
                                  name="curves"),
                TestMetricSummaries()]

    # ---- seeding ---------------------------------------------------------
    def configure_seeds(self, seed: int):
        np.random.seed(seed)

    def rng(self, seed: int):
        return jax.random.key(seed)
