"""Device-side halo exchange + partitioned full-graph training.

Per layer, each device refreshes its halo slots (features of remote sender
nodes) with ONE ``all_to_all`` over the ``graph`` mesh axis, then runs the
ordinary local aggregation — the convs themselves are unchanged; they see an
extended Graph whose senders index ``[owned | halo]`` rows. Combined with
psum'd gradients and sync-BN (global statistics), a partitioned step
reproduces single-device numerics exactly (tested by
tests/test_partition.py equivalence gates).

This is the tensor/sequence-parallel analog for GNNs described in SURVEY
§2.4 / §5 ("edge-partitioned full-graph training with per-layer halo
exchange"); the reference has no distributed layer at all.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map as _shard_map
from jax.sharding import PartitionSpec as P

from egc_tpu.nn.module import Module, Dense, Dropout
from egc_tpu.graph.structure import Graph
from egc_tpu.models.nets import ConvSpec, _torch_dense
from egc_tpu.nn import MaskedBatchNorm


class EGConvOverlap(Module):
    """EGConv with the halo exchange OVERLAPPED with the interior sweep.

    Parameter-tree compatible with ``egc_tpu.nn.conv.EGConv`` (same
    submodule names: bases/comb/bias), so single-device checkpoints apply
    directly. Math is identical; only the schedule differs: the
    ``all_to_all`` for boundary-sender features is issued FIRST with no
    data dependency on the interior work, so XLA's latency-hiding
    scheduler runs it concurrently with the owned-row bases/comb matmuls
    and the interior-edge aggregation (edges ``[0, e_interior)`` have
    owned senders — ``egc_tpu.parallel.partition`` lays them out first).
    Interior and boundary partial aggregations combine exactly at the
    primitive level (BASELINE north star: "overlapping the halo exchange
    with local aggregation").
    """

    out_channels: int
    e_interior: int
    num_heads: int = 8
    num_bases: int = 4
    aggrs: Tuple[str, ...] = ("symnorm",)
    weighting: str = "none"
    self_loop_mode: str = "paper"
    use_bias: bool = True
    axis: str = "graph"

    def __call__(self, g: Graph, x, send_idx, *, train: bool = False):
        import jax.numpy as jnp  # noqa: F811 (clarity)
        from egc_tpu.nn import init as einit
        from egc_tpu.ops.segment import (
            canonical_aggr, prims_needed, segment_primitives,
            combine_primitives, assemble_aggregators,
        )

        H, B = self.num_heads, self.num_bases
        aggrs = tuple(canonical_aggr(a) for a in self.aggrs)
        A = len(aggrs)
        O = self.out_channels
        L = O // H
        num_parts, halo = send_idx.shape
        n_ext = x.shape[0]
        n_local = n_ext - num_parts * halo
        x_own = x[:n_local]

        # 1. issue the halo exchange first — independent of everything below
        send = jnp.take(x_own, send_idx, axis=0)            # [P, H, F]
        recv = jax.lax.all_to_all(send, self.axis, split_axis=0,
                                  concat_axis=0)
        recv = recv.reshape(num_parts * halo, -1)

        # 2. owned-row compute (overlaps with the collective)
        bases_dense = Dense(B * L, use_bias=False,
                            kernel_init=einit.glorot_per_base(B),
                            name="bases")
        bases_o = bases_dense(x_own)
        fan_in = x.shape[-1]
        w = Dense(H * B * A, kernel_init=einit.torch_linear_kernel,
                  bias_init=einit.torch_linear_bias(fan_in),
                  name="comb")(x_own)
        if self.weighting == "softmax":
            w = jax.nn.softmax(w.reshape(n_local, H, B * A), axis=-1)
        elif self.weighting == "sigmoid":
            w = jax.nn.sigmoid(w)
        elif self.weighting == "hardtanh":
            w = jnp.clip(w, -1.0, 1.0)
        w = w.reshape(n_local, H, B, A)

        prims = prims_needed(aggrs)
        ei = self.e_interior
        ew = g.edge_weight if "symnorm" in aggrs else None
        p_int = segment_primitives(
            bases_o, g.senders[:ei], g.receivers[:ei], prims, n_local,
            edge_mask=g.edge_mask[:ei],
            edge_w=None if ew is None else ew[:ei])

        # 3. boundary contribution (depends on recv)
        bases_h = bases_dense(recv)
        p_bnd = segment_primitives(
            bases_h, g.senders[ei:] - n_local, g.receivers[ei:], prims,
            n_local, edge_mask=g.edge_mask[ei:],
            edge_w=None if ew is None else ew[ei:])

        p = combine_primitives(p_int, p_bnd)
        include_self = self.self_loop_mode == "all"
        ssw = g.self_weight[:n_local] if (g.self_weight is not None and
                                          "symnorm" in aggrs) else None
        y = assemble_aggregators(p, bases_o, aggrs,
                                 include_self=include_self,
                                 symnorm_self_w=ssw)
        y = y.reshape(n_local, A, B, L)
        from egc_tpu.nn.conv.egc import head_mix
        z = head_mix(w, y, n_local, H, B, A, L).reshape(n_local, O)
        if self.use_bias:
            z = z + self.param("bias", jax.nn.initializers.zeros, (O,),
                               jnp.float32)
        return jnp.pad(z, ((0, n_ext - n_local), (0, 0)))


def halo_refresh(x_ext, send_idx, axis: str = "graph"):
    """Refresh halo rows from their owners.

    x_ext: [n_local + P*H, F] extended features (this device);
    send_idx: [P, H] local indices this device sends to each peer.
    Must run inside shard_map over ``axis`` with P devices.
    """
    num_parts, H = send_idx.shape
    n_local = x_ext.shape[0] - num_parts * H
    send = jnp.take(x_ext[:n_local], send_idx, axis=0)     # [P, H, F]
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
    return x_ext.at[n_local:].set(recv.reshape(num_parts * H, -1))


class DistributedNodeClassifier(Module):
    """ArxivNet/MagNet-shaped net over a partitioned graph.

    Identical math to the single-device nets (embed -> L x [conv BN ReLU
    drop +res] -> out Linear -> log_softmax), with a halo refresh after the
    embedding and after every block, and sync-BN over the mesh axis.
    """

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 3
    dropout: float = 0.5
    residual: bool = True
    num_features: int = 128
    num_classes: int = 40
    axis: str = "graph"
    use_embed: bool = True
    e_interior: Optional[int] = None   # static interior-edge split from
    # PartitionPlan.e_interior; enables the overlapped EGC path

    def __call__(self, g: Graph, send_idx, *, train: bool):
        refresh = lambda h: halo_refresh(h, send_idx, self.axis)  # noqa: E731
        overlap = self.conv.kind == "egc" and self.e_interior is not None
        x = g.nodes
        if self.use_embed:
            x = _torch_dense(self.hidden_dim, self.num_features,
                             name="embed")(x)
        if not overlap:
            x = refresh(x)
        for i in range(self.num_layers):
            identity = x
            if overlap:
                # exchange-inside-conv: halo all_to_all overlapped with the
                # interior sweep; halo rows of x stay stale (never read)
                weighting = ("softmax" if self.conv.softmax else
                             "sigmoid" if self.conv.sigmoid else
                             "hardtanh" if self.conv.hardtanh else "none")
                x = EGConvOverlap(
                    self.hidden_dim, e_interior=self.e_interior,
                    num_heads=self.conv.heads, num_bases=self.conv.bases,
                    aggrs=tuple(self.conv.aggrs), weighting=weighting,
                    self_loop_mode=self.conv.self_loop_mode,
                    axis=self.axis, name=f"EGConv_{i}")(
                        g, x, send_idx, train=train)
            else:
                x = self.conv.build(self.hidden_dim, i, self.num_layers)(
                    g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.axis)(
                x, g.node_mask, use_running_average=not train)
            x = jax.nn.relu(x)
            x = Dropout(self.dropout, deterministic=not train)(x)
            if self.residual:
                x = x + identity
            if not overlap:
                x = refresh(x)
        x = _torch_dense(self.num_classes, self.hidden_dim, name="out")(x)
        return jax.nn.log_softmax(x, axis=-1)


def init_partitioned(model, mesh, graphs, send_idx, rng,
                     axis: str = "graph"):
    """Initialize a distributed model's variables inside the mesh context
    (the forward pass contains collectives, so a bare ``model.init`` outside
    shard_map would fail with an unbound axis name)."""

    def sharded(graphs_, sidx):
        graph = jax.tree.map(lambda a: a[0], graphs_)
        return model.init(rng, graph, sidx[0], train=False)

    fn = _shard_map(sharded, mesh=mesh,
                    in_specs=(P(axis), P(axis)), out_specs=P())
    return jax.jit(fn)(graphs, send_idx)


def make_partitioned_train_step(model, mesh, axis: str = "graph"):
    """Jitted partitioned full-graph train step.

    Inputs (stacked leading partition axis, sharded over ``axis``):
    graph (extended local Graph), send_idx [P, P, H], labels [P, n_local],
    train_mask [P, n_local]; state replicated. NLL loss over global train
    nodes. No explicit gradient psum: under shard_map's checked
    (``check_vma``) transpose, the psum inside the loss already makes the
    replicated parameters' gradients global (see ``parallel.dp``).
    """

    def sharded(state, graphs, send_idx, labels, train_mask, rng):
        graph = jax.tree.map(lambda a: a[0], graphs)
        sidx = send_idx[0]
        y = labels[0]
        mask = train_mask[0]
        rng_local = jax.random.fold_in(rng, jax.lax.axis_index(axis))

        def loss_wrapped(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                graph, sidx, train=True, rngs={"dropout": rng_local},
                mutable=["batch_stats"])
            from egc_tpu.train.losses import gather_label_scores
            n_local = y.shape[0]
            nll = -gather_label_scores(out[:n_local], y)
            m = mask.astype(out.dtype)
            s = jax.lax.psum(jnp.sum(nll * m), axis)
            c = jax.lax.psum(jnp.sum(m), axis)
            return s / jnp.maximum(c, 1.0), mutated["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(
            loss_wrapped, has_aux=True)(state.params)
        return state.apply_gradients(grads, new_batch_stats=bs), loss

    step = _shard_map(
        sharded, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(step)


def make_partitioned_eval_step(model, mesh, axis: str = "graph"):
    """Returns per-partition log-probs [P, n_ext, C] (owned rows valid)."""

    def sharded(state, graphs, send_idx):
        graph = jax.tree.map(lambda a: a[0], graphs)
        out = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            graph, send_idx[0], train=False)
        return out[None]

    step = _shard_map(
        sharded, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
    )
    return jax.jit(step)
