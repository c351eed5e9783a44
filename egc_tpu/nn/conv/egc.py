"""EGC — Efficient Graph Convolution (the framework's flagship layer).

One module covers both reference implementations (they differ only in
weighting options and self-loop policy):

- the paper layer ``EfficientGraphConv`` (reference
  ``experiments/layers.py:11-147``): per-basis weight matrices, optional
  softmax over the (B*A) axis per head, or sigmoid / hardtanh gating;
  self-loops exist ONLY inside symnorm's gcn_norm — other aggregators see
  the raw edge list. Use ``self_loop_mode="paper"``.
- the upstreamed ``EGConv`` (reference
  ``experiments/optimized_layers.py:19-286``): fused bases weight, head
  mixing as one batched matmul, optional sigmoid; self-loops added for ALL
  aggregators. Use ``self_loop_mode="all"``. Precondition: input graphs are
  self-loop-free (ingestion strips loops); the reference's
  ``add_remaining_self_loops`` DEDUPS pre-existing loops, while the
  ``include_self`` fold here would count them twice. The symnorm path
  dedups exactly (``graph.transforms.symnorm_weight``) — gated by
  tests/test_reference_exec.py against the executing reference code.

Node-wise formulation (arXiv 2104.01481):

    x'_i = ||_{h=1..H}  sum_{a in A} sum_{b=1..B}
           w[i,h,b,a] * AGG_a_{j in N(i) (+ i)} (Theta_b x_j)

ONE ``multi_aggregate`` pass over the edges produces all aggregators (the
paper's "aggregator fusion"), and the head mixing is one
broadcast-multiply-reduce. EGC-S = one aggregator with softmax weighting;
EGC-M = several aggregators, no softmax.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense
from egc_tpu.graph.structure import Graph
from egc_tpu.graph.transforms import symnorm_weight
from egc_tpu.nn import init as einit
from egc_tpu.ops import canonical_aggr
from egc_tpu.ops.dispatch import conv_aggregate


def head_mix(w, y, n, H, B, A, L):
    """z[n,h,l] = sum_{b,a} w[n,h,b,a] * y[n,a,b,l] — the EGC head mixing.

    A broadcast-multiply + reduction over the tiny (B*A) axis, which XLA
    fuses into one elementwise-reduce pass, rather than an [N]-batch of
    (H x BA x L) matmuls.
    """
    w2 = w.transpose(0, 1, 3, 2).reshape(n, H, A * B, 1)     # [n,h,ab,1]
    y2 = y.reshape(n, 1, A * B, L)                           # [n,1,ab,l]
    return jnp.sum(w2 * y2, axis=2)                          # [n,h,l]


class EGConv(Module):
    out_channels: int
    num_heads: int = 8
    num_bases: int = 4
    aggrs: Tuple[str, ...] = ("symnorm",)
    weighting: str = "none"        # none | softmax | sigmoid | hardtanh
    add_self_loops: bool = True
    self_loop_mode: str = "paper"  # paper | all (see module docstring)
    use_bias: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        H, B = self.num_heads, self.num_bases
        aggrs = tuple(canonical_aggr(a) for a in self.aggrs)
        A = len(aggrs)
        O = self.out_channels
        if O % H != 0:
            raise ValueError("out_channels must be divisible by num_heads")
        L = O // H
        if self.weighting not in ("none", "softmax", "sigmoid", "hardtanh"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if self.self_loop_mode not in ("paper", "all"):
            raise ValueError(f"unknown self_loop_mode {self.self_loop_mode!r}")
        n = x.shape[0]

        # Bases ([in, B*L], glorot per basis) and per-node combination
        # weights ([in, H*B*A], torch Linear init parity).
        fan_in = x.shape[-1]
        bases = Dense(B * L, use_bias=False,
                      kernel_init=einit.glorot_per_base(B), name="bases")(x)
        w = Dense(H * B * A, kernel_init=einit.torch_linear_kernel,
                  bias_init=einit.torch_linear_bias(fan_in), name="comb")(x)
        if self.weighting == "softmax":
            # softmax across ALL bases*aggregators per head
            # (reference experiments/layers.py:112-120).
            w = jax.nn.softmax(w.reshape(n, H, B * A), axis=-1)
        elif self.weighting == "sigmoid":
            w = jax.nn.sigmoid(w)
        elif self.weighting == "hardtanh":
            w = jnp.clip(w, -1.0, 1.0)
        w = w.reshape(n, H, B, A)

        # Symnorm weights (computed in-graph; XLA CSEs the recomputation
        # across layers within a step — the analog of the reference's
        # cached=True, optimized_layers.py:126-175).
        sym_ew = sym_sw = None
        if "symnorm" in aggrs:
            if g.edge_weight is not None:
                # precomputed (transductive cache / partitioned-global) weights
                sym_ew, sym_sw = g.edge_weight, g.self_weight
            else:
                sym_ew, sym_sw = symnorm_weight(
                    g.senders, g.receivers, n, edge_mask=g.edge_mask,
                    add_self_loops=self.add_self_loops, dtype=jnp.float32)

        include_self = self.self_loop_mode == "all" and self.add_self_loops
        y = conv_aggregate(g, bases, aggrs, include_self=include_self,
                           symnorm_edge_w=sym_ew, symnorm_self_w=sym_sw)
        y = y.reshape(n, A, B, L)
        z = head_mix(w, y, n, H, B, A, L).reshape(n, O)
        if self.use_bias:
            z = z + self.param("bias", jax.nn.initializers.zeros, (O,),
                               jnp.float32)
        return z
