"""Towered MPNN baseline (reference ``experiments/layers.py:231-267``).

Per tower t: message_ij = Linear_t([x_i_t || x_j_t]); aggregate (sum or max)
at the receiver; update_i = Linear_t([agg_i_t || x_init_i_t]); then one final
Linear across the concatenated towers. No self-loops. Requires
in_dim == out_dim (as in all reference call sites: hidden -> hidden).

Factorization: the message Linear is LINEAR in the concatenated
inputs, so message_ij = P_i(x_i) + P_j(x_j) + b with node-level transforms
P_i, P_j. Then

    sum-aggregate_i = deg_i * (P_i(x_i) + b) + SUM_j P_j(x_j)
    max-aggregate_i = P_i(x_i) + b + MAX_j P_j(x_j)       (deg_i > 0)

— EXACTLY equal to the reference's per-edge form, but the edge sweep only
touches node values (no [E, 2*it] gather / per-edge matmul).
"""

from __future__ import annotations

import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense
from egc_tpu.graph.structure import Graph
from egc_tpu.nn import init as einit
from egc_tpu.ops import segment_count
from egc_tpu.ops.dispatch import conv_aggregate


class MPNNConv(Module):
    out_channels: int
    aggr: str = "sum"            # "sum" | "max"
    towers: int = 4

    def __call__(self, g: Graph, x, *, train: bool = False):
        n, T = x.shape[0], self.towers
        in_dim, out_dim = x.shape[-1], self.out_channels
        if in_dim % T or out_dim % T:
            raise ValueError("in/out dims must divide towers")
        it, ot = in_dim // T, out_dim // T

        xt = x.reshape(n, T, it)
        # Per-tower message Linear, split into receiver/sender node-level
        # transforms (see module docstring).
        wm = self.param("msg_kernel", einit.torch_linear_kernel, (T, 2 * it, ot))
        bm = self.param("msg_bias", einit.torch_linear_bias(2 * it), (T, ot))
        p_i = jnp.einsum("nti,tio->nto", xt, wm[:, :it])
        p_j = jnp.einsum("nti,tio->nto", xt, wm[:, it:])

        deg = segment_count(g.receivers, n, mask=g.edge_mask,
                            indices_are_sorted=True)
        if self.aggr in ("sum", "add"):
            s = conv_aggregate(g, p_j.reshape(n, T * ot), ("sum",))[:, 0]
            agg = deg[:, None, None] * (p_i + bm) + s.reshape(n, T, ot)
        elif self.aggr == "max":
            m = conv_aggregate(g, p_j.reshape(n, T * ot), ("max",))[:, 0]
            agg = jnp.where((deg > 0)[:, None, None],
                            p_i + bm + m.reshape(n, T, ot), 0.0)
        else:
            raise ValueError(f"unsupported MPNN aggr {self.aggr!r}")

        upd_in = jnp.concatenate([agg, xt], axis=-1)  # [N, T, ot+it]
        wu = self.param("upd_kernel", einit.torch_linear_kernel,
                        (T, ot + it, ot))
        bu = self.param("upd_bias", einit.torch_linear_bias(ot + it), (T, ot))
        upd = jnp.einsum("ntf,tfo->nto", upd_in, wu) + bu

        fan_in = out_dim
        return Dense(out_dim, kernel_init=einit.torch_linear_kernel,
                     bias_init=einit.torch_linear_bias(fan_in),
                     name="lin")(upd.reshape(n, out_dim))
