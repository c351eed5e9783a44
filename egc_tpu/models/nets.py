"""Task model zoo — re-designs of every reference network.

All families share the reference's template-method shape (embed -> L x
[conv + BN + act (+ residual)] -> readout -> head); here the template is a
``ConvSpec`` (which conv to build per layer) plus per-family modules:

- ``ZincNet``  — reference ``experiments/zinc/models.py:17-135``
- ``CifarNet`` — reference ``experiments/cifar/models.py:18-130``
- ``HIVNet``   — reference ``experiments/mol/pna_style_models.py:21-207``
- ``ArxivNet`` — reference ``experiments/arxiv/norm_models.py:14-188``
- ``CodeNet``  — reference ``experiments/code/models.py:48-310``
- ``MagNet``   — reference ``experiments/mag/models.py`` (optimized EGConv,
  out padded 352 -> truncated 349)

Batched-task models consume a padded ``Graph`` and are padding-invariant
(masked BN / pools). Full-graph models (Arxiv/Mag) take the whole graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from egc_tpu.nn.module import Module, Dense, Dropout, Embed, remat
from egc_tpu.graph.structure import Graph
from egc_tpu.nn import (
    EGConv, GCNConv, GATConv, GATv2Conv, GINConv, SAGEConv, MPNNConv, PNAConv,
    MaskedBatchNorm, MLP, get_pool,
)
from egc_tpu.nn import init as einit
from egc_tpu.models.encoders import AtomEncoder, ASTNodeEncoder

MODEL_KINDS = ("gcn", "gat", "gatv2", "gin", "mpnn-sum", "mpnn-max", "pna",
               "sage", "egc")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Everything needed to build one graph layer (reference
    ``make_graph_layer`` hooks)."""

    kind: str
    heads: int = 8
    bases: int = 4
    softmax: bool = False
    sigmoid: bool = False
    hardtanh: bool = False
    aggrs: Optional[Tuple[str, ...]] = None
    gat_dropout: float = 0.0
    avg_log_deg: float = 0.0          # PNA only (degree-histogram statistic)
    self_loop_mode: str = "paper"     # EGC only

    def build(self, hidden_dim: int, layer_idx: int, num_layers: int,
              out_dim: Optional[int] = None) -> Module:
        out = out_dim if out_dim is not None else hidden_dim
        k = self.kind
        if k == "egc":
            assert self.aggrs, "EGC requires aggrs"
            weighting = ("softmax" if self.softmax else
                         "sigmoid" if self.sigmoid else
                         "hardtanh" if self.hardtanh else "none")
            return EGConv(out, num_heads=self.heads, num_bases=self.bases,
                          aggrs=tuple(self.aggrs), weighting=weighting,
                          self_loop_mode=self.self_loop_mode)
        if k == "gcn":
            return GCNConv(out)
        if k in ("gat", "gatv2"):
            # last layer single-head (Benchmarking-GNNs holdover, reference
            # zinc/models.py:84, arxiv/norm_models.py:79-82)
            h = self.heads if layer_idx != num_layers - 1 else 1
            ctor = GATConv if k == "gat" else GATv2Conv
            return ctor(out_channels=out // h, heads=h,
                        dropout=self.gat_dropout)
        if k == "gin":
            # GINConv(nn.Linear(h, h), train_eps=True): reference
            # arxiv/norm_models.py:95, mol/pna_style_models.py:136.
            return GINConv(mlp=MLP([out]), train_eps=True)
        if k == "sage":
            return SAGEConv(out)
        if k in ("mpnn-sum", "mpnn-max"):
            return MPNNConv(out, aggr=("sum" if k == "mpnn-sum" else "max"))
        if k == "pna":
            return PNAConv(out, avg_log_deg=self.avg_log_deg)
        raise ValueError(f"unknown model kind {k!r}; supported {MODEL_KINDS}")


def _torch_dense(features: int, fan_in: int, name=None) -> Dense:
    return Dense(features, kernel_init=einit.torch_linear_kernel,
                 bias_init=einit.torch_linear_bias(fan_in), name=name)


class ZincNet(Module):
    """Embedding(28) -> L x [conv BN ReLU +res] -> pool -> MLP[h,h/2,h/4,1]."""

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 4
    in_feat_drop: float = 0.0
    residual: bool = True
    readout: str = "mean"
    bn_axis: str = None               # sync-BN mesh axis (data parallel)
    num_features: int = 28            # reference zinc/models.py:14

    def __call__(self, g: Graph, *, train: bool):
        x = Embed(self.num_features, self.hidden_dim,
                  embedding_init=einit.normal_embedding,
                  name="embedding")(g.nodes.reshape(-1))
        x = Dropout(self.in_feat_drop, deterministic=not train)(x)
        for i in range(self.num_layers):
            identity = x
            x = self.conv.build(self.hidden_dim, i, self.num_layers)(
                g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, g.node_mask,
                                  use_running_average=not train)
            x = jax.nn.relu(x)
            if self.residual:
                x = x + identity
        pooled = get_pool(self.readout)(x, g.graph_ids, g.num_graphs,
                                        g.node_mask)
        h = self.hidden_dim
        return MLP([h // 2, h // 4, 1], bn_axis=self.bn_axis)(
            pooled, g.graph_mask, train=train)


class CifarNet(Module):
    """Linear(5) -> L x [drop conv BN ReLU +res] -> pool -> MLP -> 10."""

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 4
    dropout: float = 0.0
    residual: bool = True
    readout: str = "mean"
    bn_axis: str = None
    num_features: int = 5             # reference cifar/models.py:14
    num_classes: int = 10

    def __call__(self, g: Graph, *, train: bool):
        x = _torch_dense(self.hidden_dim, self.num_features,
                         name="embedding")(g.nodes)
        for i in range(self.num_layers):
            identity = x
            x = Dropout(self.dropout, deterministic=not train)(x)
            x = self.conv.build(self.hidden_dim, i, self.num_layers)(
                g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, g.node_mask,
                                  use_running_average=not train)
            x = jax.nn.relu(x)
            if self.residual:
                x = x + identity
        pooled = get_pool(self.readout)(x, g.graph_ids, g.num_graphs,
                                        g.node_mask)
        h = self.hidden_dim
        return MLP([h // 2, h // 4, self.num_classes],
                   bn_axis=self.bn_axis)(pooled, g.graph_mask, train=train)


class HIVNet(Module):
    """AtomEncoder -> L x [conv BN ReLU +res] -> pool -> MLP -> 1 logit."""

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 4
    in_feat_drop: float = 0.0
    residual: bool = True
    readout: str = "mean"
    bn_axis: str = None

    def __call__(self, g: Graph, *, train: bool):
        x = AtomEncoder(self.hidden_dim, name="embedding")(g.nodes)
        x = Dropout(self.in_feat_drop, deterministic=not train)(x)
        for i in range(self.num_layers):
            identity = x
            x = self.conv.build(self.hidden_dim, i, self.num_layers)(
                g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, g.node_mask,
                                  use_running_average=not train)
            x = jax.nn.relu(x)
            if self.residual:
                x = x + identity
        pooled = get_pool(self.readout)(x, g.graph_ids, g.num_graphs,
                                        g.node_mask)
        h = self.hidden_dim
        return MLP([h // 2, h // 4, 1], bn_axis=self.bn_axis)(
            pooled, g.graph_mask, train=train)


class ArxivNet(Module):
    """Linear(128) -> L x [conv BN ReLU drop +res] -> Linear(40) -> log_sm.

    Full-graph transductive; one graph, no pooling.
    """

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 3
    dropout: float = 0.5
    residual: bool = True
    bn_axis: str = None
    remat: bool = False               # rematerialize conv blocks (trade
    # recompute for activation memory; needed for wide EGC-M at arxiv scale)
    num_features: int = 128           # reference arxiv/norm_models.py:10
    num_classes: int = 40
    log_probs: bool = True            # False -> raw logits (training can
    # then use the fused logsumexp NLL, train/losses.nll_scores, skipping
    # a [N, C] log-prob materialization; eval argmax is invariant)

    def __call__(self, g: Graph, *, train: bool):
        x = _torch_dense(self.hidden_dim, self.num_features, name="embed")(
            g.nodes)
        for i in range(self.num_layers):
            identity = x
            conv_mod = self.conv.build(self.hidden_dim, i, self.num_layers)
            if self.remat:
                x = remat(
                    lambda m, g_, x_: m(g_, x_, train=train))(conv_mod, g, x)
            else:
                x = conv_mod(g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, g.node_mask,
                                  use_running_average=not train)
            x = jax.nn.relu(x)
            x = Dropout(self.dropout, deterministic=not train)(x)
            if self.residual:
                x = x + identity
        x = _torch_dense(self.num_classes, self.hidden_dim, name="out")(x)
        return jax.nn.log_softmax(x, axis=-1) if self.log_probs else x


class CodeNet(Module):
    """ASTNodeEncoder -> L x [conv BN ReLU +res] -> pool -> seq_len heads.

    Returns [G, seq_len, vocab+2] logits (reference code/models.py:102-125
    returns a list of per-position logits; stacked here).
    """

    conv: ConvSpec
    hidden_dim: int
    num_layers: int = 4
    in_feat_drop: float = 0.0
    residual: bool = True
    readout: str = "mean"
    bn_axis: str = None
    vocab_size: int = 5000            # reference code/utils.py:11
    seq_len: int = 5
    num_nodeattributes: int = 10030
    max_depth: int = 20

    def __call__(self, g: Graph, *, train: bool):
        # g.nodes: [N, 3] int = (type, attr, depth)
        x = ASTNodeEncoder(self.hidden_dim,
                           num_nodeattributes=self.num_nodeattributes,
                           max_depth=self.max_depth,
                           name="embedding")(g.nodes[:, :2], g.nodes[:, 2])
        x = Dropout(self.in_feat_drop, deterministic=not train)(x)
        for i in range(self.num_layers):
            identity = x
            x = self.conv.build(self.hidden_dim, i, self.num_layers)(
                g, x, train=train)
            x = MaskedBatchNorm(axis_name=self.bn_axis)(x, g.node_mask,
                                  use_running_average=not train)
            x = jax.nn.relu(x)
            if self.residual:
                x = x + identity
        pooled = get_pool(self.readout)(x, g.graph_ids, g.num_graphs,
                                        g.node_mask)
        # One fused Dense for all token positions (5 independent heads).
        out = _torch_dense(self.seq_len * (self.vocab_size + 2),
                           self.hidden_dim, name="token_predictors")(pooled)
        return out.reshape(pooled.shape[0], self.seq_len, self.vocab_size + 2)


class MagNet(Module):
    """ogbn-mag homogeneous net: EGConv stack with out rounded 352 -> 349.

    Reference ``experiments/mag/models.py``: EGConv(cached, self-loops for all
    aggregators) layers with ReLU + dropout between; final layer emits
    OUT_ROUNDED=352 channels truncated to 349 classes (352 % heads == 0).
    """

    hidden_dim: int
    num_layers: int = 3
    dropout: float = 0.5
    heads: int = 8
    bases: int = 4
    aggrs: Tuple[str, ...] = ("symnorm",)
    remat: bool = False
    out_rounded: int = 352
    out_true: int = 349
    log_probs: bool = True            # see ArxivNet.log_probs

    def __call__(self, g: Graph, *, train: bool):
        x = g.nodes
        for i in range(self.num_layers):
            out = self.hidden_dim if i < self.num_layers - 1 else \
                self.out_rounded
            conv_mod = EGConv(out, num_heads=self.heads,
                              num_bases=self.bases,
                              aggrs=tuple(self.aggrs), self_loop_mode="all")
            if self.remat:
                x = remat(
                    lambda m, g_, x_: m(g_, x_, train=train))(conv_mod, g, x)
            else:
                x = conv_mod(g, x, train=train)
            if i < self.num_layers - 1:
                x = jax.nn.relu(x)
                x = Dropout(self.dropout, deterministic=not train)(x)
        x = x[:, :self.out_true]
        return jax.nn.log_softmax(x, axis=-1) if self.log_probs else x


def make_conv(kind: str, **kwargs) -> ConvSpec:
    """Convenience ConvSpec constructor with validation."""
    if kind not in MODEL_KINDS:
        raise ValueError(f"unknown model kind {kind!r}; supported {MODEL_KINDS}")
    if "aggrs" in kwargs and kwargs["aggrs"] is not None:
        kwargs["aggrs"] = tuple(kwargs["aggrs"])
    return ConvSpec(kind=kind, **kwargs)
