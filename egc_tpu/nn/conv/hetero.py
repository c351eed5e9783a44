"""Heterogeneous relational convolutions: RGCN + relational EGC (REGC).

Reference counterpart ``experiments/rmag/models.py:32-148`` (R-GCN example
style, per-relation SpMM). Semantics:

- ``RGCNConv``: out[t] = root_lin_t(x_t) + sum over relations (s, r, t) of
  rel_lin_r(mean-aggregate of x_s over the relation's edges).
- ``REGConv``: one SHARED bases weight over all types; per-type root
  combination (weights [N,H,B] x bases [N,B,L]); per-relation {mean, max}
  aggregation of the source bases combined with destination-conditioned
  weights [N,H,2B]. (The reference's REGC wrapper has a constructor bug,
  rmag/models.py:161 — the layer math here is the spec, per SURVEY §3.5.)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense, Dropout
from egc_tpu.graph.hetero import HeteroGraph, split_rel_key
from egc_tpu.nn import init as einit
from egc_tpu.ops import segment_mean, segment_max


def _rel_multi_aggregate(hg: HeteroGraph, key: str, x_src, n_dst: int,
                         aggrs: Tuple[str, ...]):
    """Per-relation aggregation of source-node rows into the destination
    node space (masked segment ops): returns [n_dst, A, F]."""
    fns = {"mean": segment_mean, "max": segment_max}
    gathered = jnp.take(x_src, hg.senders[key], axis=0)
    outs = [fns[a](gathered, hg.receivers[key], n_dst,
                   mask=hg.edge_mask[key]) for a in aggrs]
    return jnp.stack(outs, axis=1)


class RGCNConv(Module):
    out_channels: int

    def __call__(self, hg: HeteroGraph, x_dict, *, train: bool = False):
        out = {}
        for t in sorted(x_dict):
            fan_in = x_dict[t].shape[-1]
            out[t] = Dense(self.out_channels,
                           kernel_init=einit.torch_linear_kernel,
                           bias_init=einit.torch_linear_bias(fan_in),
                           name=f"root_{t}")(x_dict[t])
        for key in hg.relations:
            src, _, dst = split_rel_key(key)
            n_dst = hg.num_nodes(dst)
            agg = _rel_multi_aggregate(hg, key, x_dict[src], n_dst,
                                       ("mean",))[:, 0]
            out[dst] = out[dst] + Dense(
                self.out_channels, use_bias=False,
                kernel_init=einit.torch_linear_kernel,
                name=f"rel_{key}")(agg)
        return out


class REGConv(Module):
    out_channels: int
    num_heads: int = 4
    num_bases: int = 4
    aggrs: Tuple[str, ...] = ("mean", "max")   # reference uses exactly these

    def __call__(self, hg: HeteroGraph, x_dict, *, train: bool = False):
        H, B = self.num_heads, self.num_bases
        A = len(self.aggrs)
        L = self.out_channels // H
        if self.out_channels % H:
            raise ValueError("out_channels must divide num_heads")

        def mix(w2d, y2d, n, K):
            """z[n, h*L+l] = sum_k w2d[n, h*K+k] * y2d[n, k*L+l] -> [n, HL]
            (an EGC head mix; k = bases for the root path, aggregator-major
            A*B for the relation paths)."""
            return jnp.einsum("nhk,nkl->nhl", w2d.reshape(n, H, K),
                              y2d.reshape(n, K, L),
                              precision=jax.lax.Precision.HIGHEST
                              ).reshape(n, H * L)

        # shared bases across ALL node types (one Dense reused per type)
        bases_dense = Dense(B * L, use_bias=False,
                            kernel_init=einit.glorot_uniform,
                            name="bases")
        bases = {t: bases_dense(x) for t, x in sorted(x_dict.items())}

        out = {}
        for t in sorted(x_dict):
            fan_in = x_dict[t].shape[-1]
            w = Dense(H * B, kernel_init=einit.torch_linear_kernel,
                      bias_init=einit.torch_linear_bias(fan_in),
                      name=f"root_comb_{t}")(x_dict[t])
            n = x_dict[t].shape[0]
            out[t] = mix(w, bases[t], n, B)

        for key in hg.relations:
            src, _, dst = split_rel_key(key)
            n_dst = hg.num_nodes(dst)
            # [N_dst, A, B*L] stacked aggregator-major like the reference's
            # torch.stack(...).view(-1, B*A?, L) (rmag/models.py:135-139);
            # flattening gives k-major (k = a*B + b) columns, matching the
            # rel_comb weight's (n, H, A*B) reshape
            agg = _rel_multi_aggregate(hg, key, bases[src], n_dst,
                                       self.aggrs).reshape(n_dst, A * B * L)
            fan_in = x_dict[dst].shape[-1]
            w = Dense(A * H * B, kernel_init=einit.torch_linear_kernel,
                      bias_init=einit.torch_linear_bias(fan_in),
                      name=f"rel_comb_{key}")(x_dict[dst])
            out[dst] = out[dst] + mix(w, agg, n_dst, A * B)

        return out


class REGCNet(Module):
    """Hetero net (reference ``REGC``, rmag/models.py:151-212, bug fixed):
    learned embeddings for featureless node types; (L-1) x REGConv (or
    RGCNConv when use_egc=False) with ReLU+dropout; final layer ALWAYS
    RGCNConv to the class count."""

    hidden_dim: int
    num_layers: int = 2
    dropout: float = 0.5
    use_egc: bool = True
    heads: int = 8
    bases: int = 4
    num_classes: int = 349
    in_features: int = 128
    featureless_types: Tuple[str, ...] = ()
    target_type: str = "paper"

    def __call__(self, hg: HeteroGraph, *, train: bool):
        x_dict = {}
        for t in hg.node_types:
            if t in self.featureless_types:
                n = hg.num_nodes(t)
                x_dict[t] = self.param(f"emb_{t}", einit.glorot_uniform,
                                       (n, self.in_features))
            else:
                x_dict[t] = hg.nodes[t]

        for i in range(self.num_layers - 1):
            conv = (REGConv(self.hidden_dim, num_heads=self.heads,
                            num_bases=self.bases) if self.use_egc
                    else RGCNConv(self.hidden_dim))
            x_dict = conv(hg, x_dict, train=train)
            x_dict = {t: Dropout(self.dropout,
                                 deterministic=not train)(jax.nn.relu(x))
                      for t, x in x_dict.items()}
        x_dict = RGCNConv(self.num_classes)(hg, x_dict, train=train)
        return jax.nn.log_softmax(x_dict[self.target_type], axis=-1)
