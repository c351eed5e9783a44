"""PNA — Principal Neighbourhood Aggregation (PyG-parity).

Reference call sites use PyG ``PNAConv(h, h, aggregators=[mean,min,max,std],
scalers=[identity,amplification,attenuation], deg=hist, towers=4,
divide_input=True)`` (reference ``experiments/arxiv/norm_models.py:174-182``,
``experiments/code/models.py:297-304``). Semantics reproduced:

- per-tower pre-MLP on [x_i || x_j] per edge;
- aggregators concatenated, then degree scalers multiply the concat:
  amplification = log(d+1)/avg_log, attenuation = avg_log/log(d+1), with
  d = in-degree clamped to >= 1;
- avg_log is the dataset-level mean of log(deg+1), computed from the degree
  histogram exactly as PyG does (hist-weighted mean);
- per-tower post-MLP on [x_i || aggregated], towers concatenated, final
  Linear. No self-loops.

Factorization (same trick as :mod:`.mpnn`): the pre-MLP is
pre_layers=1, i.e. a single Linear — LINEAR in [x_i || x_j] — so
msg_ij = u_i + v_j with node-level transforms u = x@W_i + b, v = x@W_j.
u_i is CONSTANT within receiver i's segment, hence

    mean_j(u_i + v_j) = u_i + mean_j(v_j)          (deg_i > 0, else 0)
    min/max_j(u_i + v_j) = u_i + min/max_j(v_j)    (monotone shift)
    sum_j(u_i + v_j)  = deg_i * u_i + sum_j(v_j)
    var/std_j(u_i + v_j) = var/std_j(v_j)          (shift-invariant)

— EXACTLY the per-edge form, but the edge sweep only touches node values
(no [E, T, 2 f_in] gather or per-edge matmul) and runs as one
``conv_aggregate`` call.
Parity vs the edge-level oracle: tests/test_nn.py::test_pna_oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense
from egc_tpu.graph.structure import Graph
from egc_tpu.graph.transforms import in_degree
from egc_tpu.nn import init as einit
from egc_tpu.ops.dispatch import conv_aggregate


def avg_log_degree(deg_hist) -> float:
    """PyG ``avg_deg['log']``: histogram-weighted mean of log(d + 1)."""
    hist = np.asarray(deg_hist, dtype=np.float64)
    d = np.arange(len(hist), dtype=np.float64)
    total = hist.sum()
    return float((np.log(d + 1) * hist).sum() / max(total, 1.0))


class PNAConv(Module):
    out_channels: int
    avg_log_deg: float                      # from avg_log_degree(deg_hist)
    aggregators: Tuple[str, ...] = ("mean", "min", "max", "std")
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    towers: int = 4
    divide_input: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        n, T = x.shape[0], self.towers
        in_dim, out_dim = x.shape[-1], self.out_channels
        if self.divide_input:
            if in_dim % T:
                raise ValueError("in_channels must divide towers")
            f_in = in_dim // T
            xt = x.reshape(n, T, f_in)
        else:
            f_in = in_dim
            xt = jnp.broadcast_to(x[:, None, :], (n, T, f_in))
        if out_dim % T:
            raise ValueError("out_channels must divide towers")
        f_out = out_dim // T

        # Per-tower pre-MLP (single Linear, PyG pre_layers=1 default),
        # split into receiver/sender NODE-level transforms (see docstring).
        wpre = self.param("pre_kernel", einit.torch_linear_kernel,
                          (T, 2 * f_in, f_in))
        bpre = self.param("pre_bias", einit.torch_linear_bias(2 * f_in),
                          (T, f_in))
        u = jnp.einsum("ntf,tfo->nto", xt, wpre[:, :f_in]) + bpre
        v = jnp.einsum("ntf,tfo->nto", xt, wpre[:, f_in:])

        for a in self.aggregators:
            if a not in ("mean", "min", "max", "sum", "add", "var", "std"):
                raise ValueError(f"unsupported PNA aggregator {a!r}")
        agg_v = conv_aggregate(g, v.reshape(n, T * f_in),
                               tuple(self.aggregators))  # [N, A, T*f_in]

        rdeg = in_degree(g.receivers, n, g.edge_mask, dtype=x.dtype)
        nonempty = (rdeg > 0)[:, None, None]
        aggs = []
        for i, a in enumerate(self.aggregators):
            av = agg_v[:, i].reshape(n, T, f_in)
            if a in ("mean", "min", "max"):
                aggs.append(jnp.where(nonempty, u + av, 0.0))
            elif a in ("sum", "add"):
                aggs.append(rdeg[:, None, None] * u + av)
            else:                     # var/std: shift-invariant in u
                aggs.append(av)
        agg = jnp.concatenate(aggs, axis=-1)      # [N, T, n_aggr * f_in]

        deg = jnp.maximum(rdeg, 1.0)
        log_deg = jnp.log(deg + 1.0)[:, None, None]
        scaled = []
        for s in self.scalers:
            if s == "identity":
                scaled.append(agg)
            elif s == "amplification":
                scaled.append(agg * (log_deg / self.avg_log_deg))
            elif s == "attenuation":
                scaled.append(agg * (self.avg_log_deg / log_deg))
            else:
                raise ValueError(f"unsupported PNA scaler {s!r}")
        agg = jnp.concatenate(scaled, axis=-1)

        # Per-tower post-MLP on [x_i || aggregated] (post_layers=1).
        post_in = jnp.concatenate([xt, agg], axis=-1)
        pin = f_in * (1 + len(self.aggregators) * len(self.scalers))
        wpost = self.param("post_kernel", einit.torch_linear_kernel,
                           (T, pin, f_out))
        bpost = self.param("post_bias", einit.torch_linear_bias(pin),
                           (T, f_out))
        out = jnp.einsum("ntf,tfo->nto", post_in, wpost) + bpost

        return Dense(out_dim, kernel_init=einit.torch_linear_kernel,
                     bias_init=einit.torch_linear_bias(out_dim),
                     name="lin")(out.reshape(n, out_dim))
