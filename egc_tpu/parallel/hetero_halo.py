"""Device-side partitioned hetero training (rmag over a mesh).

Counterpart of :mod:`egc_tpu.parallel.halo` for typed graphs: one halo
``all_to_all`` per NODE TYPE per layer refreshes every relation's remote
senders at once (plan: egc_tpu.parallel.hetero_partition). The math is
identical to the single-device ``REGCNet`` (reference
``experiments/rmag/models.py:151-212``); featureless-type embeddings are
device-LOCAL trainable leaves (each device owns its nodes' embedding
rows), so their gradients must not be psum'd — shard_map's ``check_vma``
transpose handles replicated (conv) and sharded (embedding) parameters
correctly without any explicit collectives.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
from jax import shard_map as _shard_map
import optax
from jax.sharding import PartitionSpec as P

from egc_tpu.nn.module import Module, Dropout
from egc_tpu.graph.hetero import HeteroGraph
from egc_tpu.nn.conv.hetero import REGConv, RGCNConv
from egc_tpu.parallel.halo import halo_refresh


class DistributedREGCNet(Module):
    """REGCNet over a partitioned HeteroGraph: same layer stack, with a
    per-type halo refresh before the first conv and after every layer.
    Featureless-type features arrive pre-embedded in ``x_dict`` (the
    caller owns the embedding table rows — see module docstring)."""

    hidden_dim: int
    num_layers: int = 2
    dropout: float = 0.5
    use_egc: bool = True
    heads: int = 8
    bases: int = 4
    num_classes: int = 349
    target_type: str = "paper"
    axis: str = "graph"

    def __call__(self, hg: HeteroGraph, x_dict, send_idx: Dict[str, jnp.ndarray],
                 *, train: bool):
        refresh = lambda d: {t: halo_refresh(x, send_idx[t], self.axis)  # noqa: E731
                             for t, x in d.items()}
        x_dict = refresh(x_dict)
        for _ in range(self.num_layers - 1):
            conv = (REGConv(self.hidden_dim, num_heads=self.heads,
                            num_bases=self.bases) if self.use_egc
                    else RGCNConv(self.hidden_dim))
            x_dict = conv(hg, x_dict, train=train)
            x_dict = {t: Dropout(self.dropout,
                                 deterministic=not train)(jax.nn.relu(x))
                      for t, x in x_dict.items()}
            x_dict = refresh(x_dict)
        x_dict = RGCNConv(self.num_classes)(hg, x_dict, train=train)
        return jax.nn.log_softmax(x_dict[self.target_type], axis=-1)


def extend_local(x_local, n_ext: int):
    """[P?, n_local, F] owned rows -> [..., n_ext, F] with zeroed halo
    slots (filled by the in-model refresh)."""
    pad = n_ext - x_local.shape[-2]
    widths = [(0, 0)] * (x_local.ndim - 2) + [(0, pad), (0, 0)]
    return jnp.pad(x_local, widths)


def init_hetero_partitioned(model, mesh, hg_stack, x_stack, send_idx, rng,
                            axis: str = "graph"):
    def sharded(hg_, x_, sidx_):
        hg = jax.tree.map(lambda a: a[0], hg_)
        x = {t: v[0] for t, v in x_.items()}
        sidx = {t: v[0] for t, v in sidx_.items()}
        return model.init(rng, hg, x, sidx, train=False)

    fn = _shard_map(sharded, mesh=mesh,
                    in_specs=(P(axis), P(axis), P(axis)), out_specs=P())
    return jax.jit(fn)(hg_stack, x_stack, send_idx)


def build_hetero_partitioned_steps(model, mesh, emb_tx, n_ext_map,
                                   axis: str = "graph"):
    """Returns (train_step, eval_step) jitted over ``mesh``.

    ``state`` (replicated) holds the conv/head parameters; ``emb`` /
    ``emb_opt`` (sharded over ``axis``) hold the featureless-type
    embedding rows {t: [P, n_local_t, F]} and their optimizer state —
    initialize the latter with ``jax.vmap(emb_tx.init)(emb)`` so EVERY
    optax leaf (including scalar step counts) carries the leading P axis
    the sharding specs expect. ``n_ext_map``: static {type: n_ext} for the
    embedding types (pads local rows to the extended layout in-step).
    Under shard_map's checked (``check_vma``) transpose, conv gradients
    are psum'd (replicated params) and embedding gradients stay local.
    """

    def train_sharded(state, emb, emb_opt, hg_stack, x_stack, send_idx,
                      labels, train_mask, rng):
        hg = jax.tree.map(lambda a: a[0], hg_stack)
        sidx = {t: v[0] for t, v in send_idx.items()}
        y, mask = labels[0], train_mask[0]
        emb_local = {t: v[0] for t, v in emb.items()}
        emb_opt_local = jax.tree.map(lambda a: a[0], emb_opt)
        rng_local = jax.random.fold_in(rng, jax.lax.axis_index(axis))

        def loss_fn(params, emb_l):
            x_dict = {t: v[0] for t, v in x_stack.items()}
            x_dict.update({t: extend_local(v, n_ext_map[t])
                           for t, v in emb_l.items()})
            out = model.apply({"params": params}, hg, x_dict, sidx,
                              train=True, rngs={"dropout": rng_local})
            from egc_tpu.train.losses import gather_label_scores
            n_local = y.shape[0]
            nll = -gather_label_scores(out[:n_local], y)
            m = mask.astype(out.dtype)
            s_local = jnp.sum(nll * m)
            # float32 count regardless of out.dtype (a bf16 head would
            # lose integer exactness above 256)
            c_local = jnp.sum(mask.astype(jnp.float32))
            s = jax.lax.psum(s_local, axis)
            c = jax.lax.psum(c_local, axis)
            return s / jnp.maximum(c, 1.0)

        loss, (gp, ge) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(state.params, emb_local)
        new_state = state.apply_gradients(gp)
        upd, new_opt = emb_tx.update(ge, emb_opt_local, emb_local)
        new_emb = optax.apply_updates(emb_local, upd)
        return (new_state, {t: v[None] for t, v in new_emb.items()},
                jax.tree.map(lambda a: a[None], new_opt), loss)

    train = _shard_map(
        train_sharded, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P()),
        out_specs=(P(), P(axis), P(axis), P()))

    def eval_sharded(state, emb, hg_stack, x_stack, send_idx):
        hg = jax.tree.map(lambda a: a[0], hg_stack)
        sidx = {t: v[0] for t, v in send_idx.items()}
        x_dict = {t: v[0] for t, v in x_stack.items()}
        x_dict.update({t: extend_local(v[0], n_ext_map[t])
                       for t, v in emb.items()})
        out = model.apply({"params": state.params}, hg, x_dict, sidx,
                          train=False)
        return out[None]

    evalf = _shard_map(
        eval_sharded, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis))

    return jax.jit(train), jax.jit(evalf)
