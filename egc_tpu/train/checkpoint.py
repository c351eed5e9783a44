"""Checkpoint persist/restore — the reference's ``persist_trial`` /
``restore_trial`` contract (reference ``experiments/exp_config.py:31-53``):
{model, opt, lr_scheduler, hparams} saved per trial directory.

Implementation: the array pytrees go to ``checkpoint.npz``, one entry per
leaf keyed by its tree path (``params/EGConv_0/bases/kernel``,
``opt_state/0/mu/...``); hparams and scheduler scalars go to
``checkpoint.json``. Layout-stable: restoring needs only a template state
with the same tree structure, and leaves are host arrays, so a file saved
from a mesh-sharded state restores on any device topology.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

from egc_tpu.train.optim import PlateauState

CKPT_FILE = "checkpoint.npz"


def _flat(prefix: str, tree) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join([prefix] + [_key_str(k) for k in path])
        out[key] = np.asarray(jax.device_get(leaf))
    return out


def _key_str(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _restore(prefix: str, template, arrays):
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, leaf in paths:
        key = "/".join([prefix] + [_key_str(k) for k in path])
        if key not in arrays:
            raise KeyError(f"checkpoint has no entry {key!r}")
        value = arrays[key]
        if np.shape(value) != np.shape(leaf):
            raise ValueError(f"{key}: checkpoint shape {np.shape(value)} "
                             f"!= template shape {np.shape(leaf)}")
        leaves.append(value)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_checkpoint(ckpt_dir, *, state, plateau: Optional[PlateauState] = None,
                    hparams: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name in ("params", "batch_stats", "opt_state"):
        arrays.update(_flat(name, getattr(state, name)))
    arrays["step"] = np.asarray(jax.device_get(state.step))
    with open(ckpt_dir / CKPT_FILE, "wb") as f:
        np.savez(f, **arrays)
    meta = {
        "hparams": hparams or {},
        "plateau": list(plateau) if plateau is not None else None,
        "extra": extra or {},
    }
    (ckpt_dir / "checkpoint.json").write_text(json.dumps(meta, default=float))
    return ckpt_dir / CKPT_FILE


def load_checkpoint(ckpt_dir, *, state_template):
    """Restore (state, plateau, hparams) from a trial directory.

    ``state_template`` is a freshly-created TrainState with the right tree
    structure (reference restore rebuilds model+opt then loads state dicts,
    ``experiments/zinc/configs.py:165-180`` — same flow here).
    """
    ckpt_dir = Path(ckpt_dir)
    with np.load(ckpt_dir / CKPT_FILE, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    state = state_template.replace(
        params=_restore("params", state_template.params, arrays),
        batch_stats=_restore("batch_stats", state_template.batch_stats,
                             arrays),
        opt_state=_restore("opt_state", state_template.opt_state, arrays),
        step=int(arrays["step"]),
    )
    meta = json.loads((ckpt_dir / "checkpoint.json").read_text())
    plateau = None
    if meta.get("plateau") is not None:
        vals = meta["plateau"]
        plateau = PlateauState(lr=vals[0], best=vals[1], num_bad=int(vals[2]),
                               mode=vals[3], factor=vals[4],
                               patience=int(vals[5]), min_lr=vals[6],
                               threshold=vals[7])
    return state, plateau, meta.get("hparams", {})
