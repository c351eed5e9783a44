"""GCN / GIN / GraphSAGE convolutions (PyG-parity semantics).

These replace the PyG conv zoo the reference imports (reference
``experiments/arxiv/norm_models.py``, ``experiments/mol/pna_style_models.py``).
Self-loops are virtual (folded analytically) — see egc_tpu.ops.segment.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense
from egc_tpu.graph.structure import Graph
from egc_tpu.graph.transforms import symnorm_weight
from egc_tpu.nn import init as einit
from egc_tpu.ops.dispatch import conv_aggregate


class GCNConv(Module):
    """x' = D^-1/2 (A + I) D^-1/2 X Theta + b  (PyG GCNConv defaults)."""

    out_channels: int
    add_self_loops: bool = True
    use_bias: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        n = x.shape[0]
        h = Dense(self.out_channels, use_bias=False,
                  kernel_init=einit.glorot_uniform, name="lin")(x)
        if g.edge_weight is not None:
            ew, sw = g.edge_weight, g.self_weight
        else:
            ew, sw = symnorm_weight(g.senders, g.receivers, n,
                                    edge_mask=g.edge_mask,
                                    add_self_loops=self.add_self_loops,
                                    dtype=jnp.float32)
        out = conv_aggregate(g, h, ("symnorm",), symnorm_edge_w=ew,
                             symnorm_self_w=sw)[:, 0]
        if self.use_bias:
            out = out + self.param("bias", jax.nn.initializers.zeros,
                                   (self.out_channels,), jnp.float32)
        return out


class GINConv(Module):
    """x' = nn((1 + eps) x + sum_j x_j)  (PyG GINConv, eps fixed at 0 unless
    train_eps)."""

    mlp: Callable            # a Module applied to the aggregated features
    eps: float = 0.0
    train_eps: bool = False

    def __call__(self, g: Graph, x, *, train: bool = False):
        n = x.shape[0]
        agg = conv_aggregate(g, x, ("sum",))[:, 0]
        if self.train_eps:
            eps = self.param("eps", lambda k, s: jnp.full(s, self.eps), ())
        else:
            eps = self.eps
        return self.mlp((1.0 + eps) * x + agg, train=train)


class SAGEConv(Module):
    """x' = W_l mean_j(x_j) + W_r x  (PyG SAGEConv defaults: mean aggr,
    root weight, bias on the neighbor path only)."""

    out_channels: int
    use_bias: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        n = x.shape[0]
        agg = conv_aggregate(g, x, ("mean",))[:, 0]
        fan_in = x.shape[-1]
        out = Dense(self.out_channels, use_bias=self.use_bias,
                    kernel_init=einit.torch_linear_kernel,
                    bias_init=einit.torch_linear_bias(fan_in),
                    name="lin_l")(agg)
        out = out + Dense(self.out_channels, use_bias=False,
                          kernel_init=einit.torch_linear_kernel,
                          name="lin_r")(x)
        return out
