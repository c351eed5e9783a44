"""egc_tpu CLI — mirrors the reference driver surface
(reference ``main.py:211-372``):

    python main.py EXP_DIR MODEL DATASET [options]

Modes: --check (smoke), --pretrained (restore + test from EXP_DIR),
hyperparameter search (default), --use-default-hparams / --hparams to skip
search and go straight to seeded final runs.

Deviations from the reference, by design:
- ``--hparams`` is parsed with ast.literal_eval, not eval (reference
  main.py:356 uses eval — SURVEY §7.3 known quirk).
- ``--pretrained`` restores a local checkpoint directory (this environment
  has no network egress; the reference downloads Dropbox checkpoints).
- ``--synthetic/--real``: synthetic datasets are the default here (no
  egress); --real requires datasets on disk under DATASET_LOC.
- No Ray: search runs in-process, or across CPU worker processes with
  ``--search-workers`` (egc_tpu.exp.parallel_search).

``main(argv)`` runs the CLI in-process (``argv`` without the program name).
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import time
from pathlib import Path

from egc_tpu.exp.batched import ZincConfig, CifarConfig, MolConfig, CodeConfig
from egc_tpu.exp.fullgraph import ArxivConfig, MagConfig
from egc_tpu.exp.runner import check_config, train_final_models
from egc_tpu.exp.search import run_search

MODELS = ["gcn", "gat", "egc", "gin", "mpnn-sum", "mpnn-max", "pna", "sage",
          "gatv2"]
DATASETS = ["zinc", "hiv", "arxiv", "cifar", "code", "rmag", "mag"]

# reference support matrix (main.py:56-208)
SUPPORTED = {
    "zinc": {"egc", "gatv2"},
    "cifar": {"egc", "gatv2"},
    "hiv": {"egc", "gcn", "gat", "gatv2", "gin", "mpnn-sum", "mpnn-max",
            "sage"},
    "arxiv": set(MODELS),
    "code": set(MODELS),
    "mag": {"egc"},
    "rmag": {"egc"},
}


class UsageError(ValueError):
    """An invalid combination of CLI arguments."""


def _conv_kwargs(model, heads, bases, aggrs):
    kw = {}
    if model == "egc":
        if aggrs is None:
            raise UsageError("--aggrs is required for egc")
        kw.update(heads=heads or 8, bases=bases or 4,
                  aggrs=tuple(aggrs.split(",")))
    return kw


def build_config(dataset, model, *, hidden, heads, bases, aggrs,
                 num_samples, synthetic=True, use_old_code_dataset=False,
                 partitions=0, sampled=False, device_sampler=False):
    if model not in SUPPORTED[dataset]:
        raise UsageError(
            f"{model!r} not supported for {dataset!r} "
            f"(supported: {sorted(SUPPORTED[dataset])})")
    if (sampled or device_sampler) and dataset != "mag":
        raise UsageError(
            "--sampled/--device-sampler apply to the mag dataset only")
    if hidden is None:
        raise UsageError("--hidden is required")
    kw = _conv_kwargs(model, heads, bases, aggrs)
    if dataset == "zinc":
        cfg = ZincConfig(model, hidden, **kw)
    elif dataset == "cifar":
        cfg = CifarConfig(model, hidden, **kw)
    elif dataset == "hiv":
        cfg = MolConfig(model, hidden, **kw)
    elif dataset == "code":
        cfg = CodeConfig(model, hidden,
                         use_old_code_dataset=use_old_code_dataset, **kw)
    elif dataset == "arxiv":
        if partitions:
            from egc_tpu.exp.fullgraph import PartitionedArxivConfig
            cfg = PartitionedArxivConfig(
                model, hidden, heads=heads or 8, bases=bases or 8,
                aggrs=tuple(aggrs.split(",")) if aggrs else None,
                gat_version=2 if model == "gatv2" else 1,
                partitions=partitions)
        else:
            cfg = ArxivConfig(model, hidden, heads=heads or 8,
                              bases=bases or 8,
                              aggrs=tuple(aggrs.split(",")) if aggrs else None,
                              gat_version=2 if model == "gatv2" else 1)
    elif dataset == "mag":
        mag_kw = dict(heads=heads or 8, bases=bases or 4,
                      aggrs=tuple(aggrs.split(",")) if aggrs else
                      ("symnorm",))
        if sampled or device_sampler:
            # neighbor-sampled MAG (BASELINE sampled path); with
            # --device-sampler the layered sample runs INSIDE the jitted
            # step (egc_tpu.data.device_sampling)
            from egc_tpu.exp.fullgraph import SampledMagConfig
            cfg = SampledMagConfig(model, hidden,
                                   device_sampler=device_sampler, **mag_kw)
        else:
            cfg = MagConfig(model, hidden, **mag_kw)
    elif dataset == "rmag":
        if partitions:
            from egc_tpu.exp.hetero import PartitionedRMagConfig
            cfg = PartitionedRMagConfig(hidden, heads=heads or 4,
                                        bases=bases or 4,
                                        partitions=partitions)
        else:
            from egc_tpu.exp.hetero import RMagConfig
            cfg = RMagConfig(hidden, heads=heads or 4, bases=bases or 4)
    else:
        raise UsageError(f"unknown dataset {dataset}")
    cfg.synthetic = synthetic
    cfg._num_samples = num_samples
    return cfg


def dump_invocation_state(exp_dir: Path):
    (exp_dir / "invocation.json").write_text(json.dumps({
        "argv": sys.argv, "time": time.strftime("%Y-%m-%d %H:%M:%S"),
    }))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="main.py", description="Train EGC and baseline GNNs.")
    ap.add_argument("exp_directory")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("dataset", choices=DATASETS)
    ap.add_argument("--num-samples", type=int, default=50)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--check-epochs", type=int, default=200)
    ap.add_argument("--use-default-hparams", action="store_true")
    ap.add_argument("--hparams", type=str, default=None)
    ap.add_argument("--egc-num-bases", type=int, default=None)
    ap.add_argument("--egc-num-heads", type=int, default=None)
    ap.add_argument("--final-runs", type=int, default=None)
    ap.add_argument("--aggrs", type=str, default=None)
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--use-old-code-dataset", action="store_true")
    ap.add_argument("--pretrained", action="store_true")
    ap.add_argument("--partitions", type=int, default=0,
                    help="graph-partitioned training across N devices "
                         "(full-graph tasks; halo exchange over the mesh)")
    ap.add_argument("--search-workers", type=int, default=0,
                    help="run the hyperparameter search across N CPU worker "
                         "processes (trial parallelism, the Ray role; the "
                         "accelerator stays free for the final runs)")
    data = ap.add_mutually_exclusive_group()
    data.add_argument("--synthetic", dest="synthetic", action="store_true",
                      default=True,
                      help="synthetic datasets (default; no-egress "
                           "environment)")
    data.add_argument("--real", dest="synthetic", action="store_false",
                      help="real datasets from DATASET_LOC")
    ap.add_argument("--sampled", action="store_true",
                    help="mag only: neighbor-sampled mini-batch training "
                         "with deterministic full-graph eval "
                         "(SampledMagConfig)")
    ap.add_argument("--device-sampler", action="store_true",
                    help="mag only: implies --sampled; the layered neighbor "
                         "sample runs INSIDE the jitted train step "
                         "(data/device_sampling.py)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    try:
        _run(args)
    except UsageError as e:
        ap.error(str(e))


def _run(args):
    from egc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    exp_directory = Path(args.exp_directory).expanduser()
    exp_directory.mkdir(parents=True, exist_ok=True)

    config = build_config(
        args.dataset, args.model, hidden=args.hidden,
        heads=args.egc_num_heads, bases=args.egc_num_bases, aggrs=args.aggrs,
        num_samples=args.num_samples, synthetic=args.synthetic,
        use_old_code_dataset=args.use_old_code_dataset,
        partitions=args.partitions, sampled=args.sampled,
        device_sampler=args.device_sampler)

    if args.pretrained:
        # architecture must match the published pretrained config exactly
        # (reference load_pretrained asserts, zinc/configs.py:264-284)
        from egc_tpu.exp.pretrained import validate_pretrained
        validate_pretrained(args.dataset, args.model, config)
        pt = exp_directory / "checkpoint.pt"
        if pt.exists():
            # reference torch-format checkpoint: numpy-only read + layout
            # port (egc_tpu.exp.weight_port; no torch dependency)
            from egc_tpu.exp.weight_port import restore_pretrained_pt
            model_obj, state, data = restore_pretrained_pt(
                config, args.dataset, pt, seed=args.seed_base)
            print(model_obj)
            print(config.test(model_obj, state, data))
            return
        model_obj, state, plateau, hp, data = config.restore_trial(
            exp_directory)
        print(model_obj)
        print(hp)
        print(config.test(model_obj, state, data))
        return

    if args.check:
        res = check_config(config, args.check_epochs)
        print({k: res[k] for k in ("best_val", "best_iter", "test")})
        return

    dump_invocation_state(exp_directory)

    if args.hparams is not None:
        best_hparams = ast.literal_eval(args.hparams)
        print("Using given hyperparams:", best_hparams)
    elif args.use_default_hparams:
        best_hparams = config.default_hparams()
        print("Using default hyperparams:", best_hparams)
    elif args.search_workers > 1:
        # trial parallelism across worker processes (the Ray role)
        import numpy as np
        from egc_tpu.exp.parallel_search import run_search_parallel
        metric = config.trial_metric()
        rng = np.random.default_rng(args.seed_base)
        candidates = config.search_strategy().generate(
            config.hyperparams(), rng)
        spec = ("main", "build_config", (args.dataset, args.model), dict(
            hidden=args.hidden, heads=args.egc_num_heads,
            bases=args.egc_num_bases, aggrs=args.aggrs,
            num_samples=args.num_samples, synthetic=args.synthetic,
            use_old_code_dataset=args.use_old_code_dataset,
            partitions=args.partitions, sampled=args.sampled,
            device_sampler=args.device_sampler))
        best_hparams = run_search_parallel(
            spec, candidates, metric_mode=metric.mode,
            metric_name=metric.name, num_workers=args.search_workers,
            exp_dir=exp_directory, seed=args.seed_base,
            resources=config.resource_requirements(),
            scheduler=config.trial_scheduler())
        print("Best hparams:", best_hparams)
    else:
        # strategy + scheduler come from config.search_strategy() /
        # config.trial_scheduler() (reference exptune hook surface)
        best_hparams = run_search(config, exp_directory, seed=args.seed_base)
        print("Best hparams:", best_hparams)

    train_final_models(config, best_hparams, exp_directory,
                       override_repeats=args.final_runs,
                       seed_base=args.seed_base)


if __name__ == "__main__":
    main()
