"""Task metric implementations (the reference delegates these to OGB
evaluators; implemented natively here, numpy host-side).

- ``accuracy``: ogbn-arxiv / mag Evaluator semantics (exact match rate).
- ``roc_auc``: ogbg-molhiv Evaluator (binary ROC-AUC). Computed via the
  Mann-Whitney U statistic with average tie-ranks — identical to
  sklearn.roc_auc_score on binary labels.
- ``sequence_f1``: ogbg-code2 Evaluator: per-sample set-overlap
  precision/recall/F1 over decoded token sequences, averaged.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def accuracy(pred_labels, true_labels) -> float:
    pred_labels = np.asarray(pred_labels)
    true_labels = np.asarray(true_labels)
    return float((pred_labels == true_labels).mean())


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC (labels in {0,1}), average ranks for ties."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    # average ranks over ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def sequence_f1(seq_pred: Sequence[List], seq_ref: Sequence[List]) -> float:
    """OGB code2 F1: set-overlap precision/recall/F1 per sample, averaged."""
    f1s = []
    for p, r in zip(seq_pred, seq_ref):
        ps, rs = set(p), set(r)
        tp = len(ps & rs)
        prec = tp / len(ps) if ps else 0.0
        rec = tp / len(rs) if rs else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        f1s.append(f1)
    return float(np.mean(f1s)) if f1s else 0.0


def _split_acc_compute(out, y, m_tr, m_va, m_te):
    import jax.numpy as jnp

    pred = jnp.argmax(out, axis=-1)

    def acc(m):
        return jnp.sum((pred == y) & m) / jnp.maximum(jnp.sum(m), 1)

    return jnp.stack([acc(m_tr), acc(m_va), acc(m_te)])


import jax  # noqa: E402 (jit wrapper creation only; no tracing at import)

_split_acc_jit = jax.jit(_split_acc_compute)


def split_accuracies(out, y, masks: dict) -> dict:
    """{split}_acc over log-prob rows in ONE jitted call + ONE device
    read (per-op eager dispatch costs a host<->device round trip each).
    The jitted
    callable is module-global so repeated epochs hit the trace cache."""
    splits = ("train", "val", "test")
    vals = np.asarray(_split_acc_jit(out, y, *[masks[s] for s in splits]))
    return {f"{s}_acc": float(v) for s, v in zip(splits, vals)}
