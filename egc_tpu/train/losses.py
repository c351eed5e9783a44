"""Device-side loss helpers.

The reference uses ``F.nll_loss`` / ``F.cross_entropy`` (e.g.
``experiments/arxiv/configs.py``). The label score is taken with a one-hot
multiply-reduce, which XLA fuses with its producer, instead of a
``take_along_axis`` row gather.
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_label_scores(out: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """``out[i, labels[i]]`` as a one-hot multiply-reduce (no row gather).

    ``out``: [N, C] scores; ``labels``: [N] integer class ids.
    Returns [N].
    """
    classes = out.shape[-1]
    onehot = labels[:, None].astype(jnp.int32) == jnp.arange(
        classes, dtype=jnp.int32)
    return jnp.sum(jnp.where(onehot, out, 0), axis=-1)


def nll_scores(out: jnp.ndarray, labels: jnp.ndarray, *,
               log_probs: bool = True) -> jnp.ndarray:
    """Per-row NLL from model scores.

    ``log_probs=True``: scores are log-probabilities, nll = -score[y].
    ``log_probs=False``: scores are raw logits, nll = lse(out) - out[y] —
    mathematically identical but skips materializing the [N, C] log-prob
    array and its cotangent (pair with
    ``ArxivNet/MagNet(log_probs=False)``)."""
    s = gather_label_scores(out, labels)
    if log_probs:
        return -s
    import jax

    return jax.scipy.special.logsumexp(out, axis=-1) - s
