"""GAT / GATv2 attention convolutions with virtual self-loop softmax.

PyG-parity semantics (the reference's GAT baselines, e.g.
``experiments/zinc/models.py:81-89`` uses GATv2Conv; arxiv/mol nets pass a
tunable attention ``dropout``): attention over incoming edges plus the node
itself (PyG ``add_self_loops=True`` default), LeakyReLU slope 0.2, per-head
softmax at the receiver, dropout on the normalized attention coefficients in
training (PyG applies F.dropout to alpha after softmax), heads concatenated.

Instead of materializing self-loop edges, the self term enters the segment
softmax analytically (one fewer gather per edge, static shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense, Dropout
from egc_tpu.graph.structure import Graph
from egc_tpu.nn import init as einit
from egc_tpu.ops import segment_sum


def _attention_alphas(edge_logits, self_logits, receivers, num_nodes,
                      edge_mask, include_self):
    """Normalized attention over {incoming edges} (∪ {self}) per receiver.

    edge_logits: [E, H]; self_logits: [N, H].
    Returns (alpha_edge [E, H], alpha_self [N, H] or None).
    """
    from egc_tpu.ops.segment import _segment_max_raw

    neg = jnp.asarray(-1e30, edge_logits.dtype)
    masked_logits = edge_logits
    if edge_mask is not None:
        masked_logits = jnp.where(edge_mask[:, None], edge_logits, neg)
    # _segment_max_raw: single-gather VJP (see ops.segment)
    mx = _segment_max_raw(masked_logits, receivers, num_nodes, False)
    mx = jnp.maximum(mx, neg)  # empty segments: -inf -> -1e30
    if include_self:
        mx = jnp.maximum(mx, self_logits)

    ex = jnp.exp(masked_logits - mx[receivers])
    if edge_mask is not None:
        ex = jnp.where(edge_mask[:, None], ex, jnp.zeros_like(ex))
    denom = segment_sum(ex, receivers, num_nodes)
    ex_self = None
    if include_self:
        ex_self = jnp.exp(self_logits - mx)
        denom = denom + ex_self
    denom = jnp.maximum(denom, jnp.asarray(1e-16, denom.dtype))
    alpha_edge = ex / denom[receivers]
    alpha_self = ex_self / denom if include_self else None
    return alpha_edge, alpha_self


class _AttentionConvBase(Module):
    """Shared alpha -> dropout -> weighted-sum plumbing."""

    def _aggregate(self, alpha_edge, alpha_self, edge_vals, self_vals,
                   receivers, num_nodes, dropout, train):
        if dropout > 0.0:
            alpha_edge = Dropout(dropout, deterministic=not train)(alpha_edge)
            if alpha_self is not None:
                alpha_self = Dropout(dropout,
                                     deterministic=not train)(alpha_self)
        out = segment_sum(alpha_edge[:, :, None] * edge_vals, receivers,
                          num_nodes)
        if alpha_self is not None:
            out = out + alpha_self[:, :, None] * self_vals
        return out


class GATConv(_AttentionConvBase):
    """PyG GATConv: logits_ij = LeakyReLU(a_src . Wx_j + a_dst . Wx_i)."""

    out_channels: int            # per-head
    heads: int = 1
    negative_slope: float = 0.2
    dropout: float = 0.0         # attention-coefficient dropout
    add_self_loops: bool = True
    use_bias: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        n, H, C = x.shape[0], self.heads, self.out_channels
        h = Dense(H * C, use_bias=False, kernel_init=einit.glorot_uniform,
                  name="lin")(x).reshape(n, H, C)
        att_src = self.param("att_src", einit.glorot_uniform, (H, C))
        att_dst = self.param("att_dst", einit.glorot_uniform, (H, C))
        a_src = jnp.einsum("nhc,hc->nh", h, att_src)
        a_dst = jnp.einsum("nhc,hc->nh", h, att_dst)

        self_logits = jax.nn.leaky_relu(a_src + a_dst,
                                        negative_slope=self.negative_slope)
        edge_logits = jax.nn.leaky_relu(
            jnp.take(a_src, g.senders, axis=0) +
            jnp.take(a_dst, g.receivers, axis=0),
            negative_slope=self.negative_slope)
        alpha_e, alpha_s = _attention_alphas(
            edge_logits, self_logits, g.receivers, n, g.edge_mask,
            self.add_self_loops)
        out = self._aggregate(alpha_e, alpha_s,
                              jnp.take(h, g.senders, axis=0), h,
                              g.receivers, n, self.dropout, train)
        out = out.reshape(n, H * C)
        if self.use_bias:
            out = out + self.param("bias", jax.nn.initializers.zeros,
                                   (H * C,), jnp.float32)
        return out


class GATv2Conv(_AttentionConvBase):
    """PyG GATv2Conv: logits_ij = a . LeakyReLU(W_l x_j + W_r x_i)."""

    out_channels: int            # per-head
    heads: int = 1
    negative_slope: float = 0.2
    dropout: float = 0.0         # attention-coefficient dropout
    add_self_loops: bool = True
    share_weights: bool = False
    use_bias: bool = True

    def __call__(self, g: Graph, x, *, train: bool = False):
        n, H, C = x.shape[0], self.heads, self.out_channels
        hl = Dense(H * C, use_bias=True, kernel_init=einit.glorot_uniform,
                   bias_init=jax.nn.initializers.zeros,
                   name="lin_l")(x).reshape(n, H, C)
        if self.share_weights:
            hr = hl
        else:
            hr = Dense(H * C, use_bias=True,
                       kernel_init=einit.glorot_uniform,
                       bias_init=jax.nn.initializers.zeros,
                       name="lin_r")(x).reshape(n, H, C)
        att = self.param("att", einit.glorot_uniform, (H, C))

        def logits(src_feat, dst_feat):
            z = jax.nn.leaky_relu(src_feat + dst_feat,
                                  negative_slope=self.negative_slope)
            return jnp.einsum("nhc,hc->nh", z, att)

        self_logits = logits(hl, hr)
        edge_logits = logits(jnp.take(hl, g.senders, axis=0),
                             jnp.take(hr, g.receivers, axis=0))
        alpha_e, alpha_s = _attention_alphas(
            edge_logits, self_logits, g.receivers, n, g.edge_mask,
            self.add_self_loops)
        out = self._aggregate(alpha_e, alpha_s,
                              jnp.take(hl, g.senders, axis=0), hl,
                              g.receivers, n, self.dropout, train)
        out = out.reshape(n, H * C)
        if self.use_bias:
            out = out + self.param("bias", jax.nn.initializers.zeros,
                                   (H * C,), jnp.float32)
        return out
