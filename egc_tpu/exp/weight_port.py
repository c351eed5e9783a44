"""Reference torch-checkpoint <-> JAX pytree weight porting.

Converts the reference's ``model.state_dict()`` tensors (read without torch
by :mod:`egc_tpu.utils.torch_pt`) into this framework's model variables, for
every (dataset, model) family in the pretrained registry — so reference
pretrained checkpoints can be evaluated for task-metric parity without
retraining (reference ``experiments/utils.py:69-79`` ``load_pretrained``).

Layout shims handled here (all verified by tests/test_torch_import.py
against torch-built oracles):

- torch ``nn.Linear`` weights are [out, in]; Dense kernels are
  [in, out] (transposed).
- paper ``EfficientGraphConv`` (zinc/cifar/hiv/arxiv/code EGC rows): the
  per-basis ``bases_weight.{b}`` [in, L] ParameterList concatenates into our
  fused [in, B*L] kernel; ``comb_weights`` column order (h, b, a) matches
  ours directly (reference ``experiments/layers.py:49-65,127-135``).
- optimized ``EGConv`` (mag): ``comb_weight`` columns are aggregator-major
  (h, a*B + b) because the head mix multiplies an (A*B, L)-stacked
  aggregate (reference ``experiments/optimized_layers.py:195-205``); ours
  are bases-major (h, b, a) — the permutation shim in ``_comb_perm``
  (SURVEY §7.1 step 3).
- towered MPNN / PNA: per-tower Linear lists stack into our [T, in, out]
  kernels (reference ``experiments/layers.py:236-242``, PyG PNAConv
  pre_nns/post_nns).
- code2 ``token_predictors.{s}`` head list fuses into one [h, S*(V+2)]
  kernel (reference ``experiments/code/models.py:95-98``).
- GAT/GATv2 ``att*`` [1, H, C] squeeze to [H, C]; PyG naming variants
  (lin_src/lin_l/lin, att_src/att_l/att_i) accepted.
- REGConv ``rel_combs`` columns are (h, a*B + b) in BOTH implementations
  (reference ``experiments/rmag/models.py:129-143`` stacks {mean, max}
  aggregator-major and ours mirrors that) — transpose only.

``export_model_state`` is the exact inverse (used by the round-trip parity
tests and for handing weights back to torch users).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

FAMILY = {"zinc": "batched", "cifar": "batched", "hiv": "batched",
          "code": "batched", "arxiv": "arxiv", "mag": "mag", "rmag": "rmag"}

_CONV_CLS = {"gcn": "GCNConv", "gat": "GATConv", "gatv2": "GATv2Conv",
             "gin": "GINConv", "sage": "SAGEConv", "mpnn-sum": "MPNNConv",
             "mpnn-max": "MPNNConv", "pna": "PNAConv", "egc": "EGConv"}


class PortError(ValueError):
    pass


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _get(sd: Dict[str, np.ndarray], prefix: str, *names: str) -> np.ndarray:
    for n in names:
        if prefix + n in sd:
            return np.asarray(sd[prefix + n])
    raise PortError(f"none of {[prefix + n for n in names]} in state dict "
                    f"(have e.g. {sorted(sd)[:8]}...)")


def _comb_perm(H: int, B: int, A: int) -> np.ndarray:
    """perm such that ours[:, j] = torch[:, perm[j]] for the optimized
    EGConv comb weight: ours j = (h, b, a), torch column = h*B*A + a*B + b."""
    perm = np.empty(H * B * A, np.int64)
    j = 0
    for h in range(H):
        for b in range(B):
            for a in range(A):
                perm[j] = h * B * A + a * B + b
                j += 1
    return perm


class _Rules:
    """Bidirectional (JAX leaf <-> torch tensors) assignment collection."""

    def __init__(self):
        self.imports: List[Tuple[Tuple[str, ...], Any]] = []
        self.exports: List[Any] = []
        self.consumed: List[str] = []

    def add(self, path, import_fn, export_fn, consumes: Iterable[str] = ()):
        self.imports.append((tuple(path), import_fn))
        self.exports.append((tuple(path), export_fn))
        self.consumed.extend(consumes)

    # -- common rule makers ------------------------------------------------
    def linear(self, path, tp: str, *, bias: bool = True,
               weight_names=("weight",), bias_name="bias"):
        """Dense at ``path`` <-> torch Linear at prefix ``tp``."""
        self.add(path + ("kernel",),
                 lambda sd: _t(_get(sd, tp, *weight_names)),
                 lambda v: {tp + weight_names[0]: _t(v)},
                 [tp + n for n in weight_names])
        if bias:
            self.add(path + (bias_name,),
                     lambda sd: np.asarray(sd[tp + "bias"]),
                     lambda v: {tp + "bias": np.asarray(v)},
                     [tp + "bias"])

    def direct(self, path, tkey: str, shape=None):
        def imp(sd, tkey=tkey, shape=shape):
            v = np.asarray(sd[tkey])
            return v.reshape(shape) if shape is not None else v
        self.add(path, imp, lambda v: {tkey: np.asarray(v)}, [tkey])

    def batchnorm(self, pparam, pstats, tp: str):
        self.direct(pparam + ("scale",), tp + "weight")
        self.direct(pparam + ("bias",), tp + "bias")
        self.direct(pstats + ("mean",), tp + "running_mean")
        self.direct(pstats + ("var",), tp + "running_var")
        self.consumed.append(tp + "num_batches_tracked")


def _egc_paper_rules(r: _Rules, path, tp: str, num_bases: int):
    def imp_bases(sd):
        return np.concatenate(
            [np.asarray(sd[f"{tp}bases_weight.{b}"]) for b in range(num_bases)],
            axis=1)

    def exp_bases(v):
        chunks = np.split(np.asarray(v), num_bases, axis=1)
        return {f"{tp}bases_weight.{b}": c for b, c in enumerate(chunks)}

    r.add(path + ("bases", "kernel"), imp_bases, exp_bases,
          [f"{tp}bases_weight.{b}" for b in range(num_bases)])
    r.linear(path + ("comb",), tp + "comb_weights.")
    r.direct(path + ("bias",), tp + "bias")


def _egc_optimized_rules(r: _Rules, path, tp: str, heads: int,
                         num_bases: int, num_aggrs: int):
    r.add(path + ("bases", "kernel"),
          lambda sd: np.asarray(sd[tp + "bases_weight"]),
          lambda v: {tp + "bases_weight": np.asarray(v)},
          [tp + "bases_weight"])
    perm = _comb_perm(heads, num_bases, num_aggrs)
    inv = np.argsort(perm)
    r.add(path + ("comb", "kernel"),
          lambda sd: _t(sd[tp + "comb_weight.weight"])[:, perm],
          lambda v: {tp + "comb_weight.weight": _t(np.asarray(v)[:, inv])},
          [tp + "comb_weight.weight"])
    r.add(path + ("comb", "bias"),
          lambda sd: np.asarray(sd[tp + "comb_weight.bias"])[perm],
          lambda v: {tp + "comb_weight.bias": np.asarray(v)[inv]},
          [tp + "comb_weight.bias"])
    r.direct(path + ("bias",), tp + "bias")


def _tower_stack_rules(r: _Rules, kpath, bpath, tlist_prefix: str,
                       towers: int, inner: str = ""):
    """[T, in, out] kernel + [T, out] bias <-> torch ModuleList of
    per-tower Linears at ``{tlist_prefix}.{t}.{inner}weight/bias``."""
    wk = [f"{tlist_prefix}.{t}.{inner}weight" for t in range(towers)]
    bk = [f"{tlist_prefix}.{t}.{inner}bias" for t in range(towers)]
    r.add(kpath,
          lambda sd: np.stack([_t(sd[k]) for k in wk]),
          lambda v: {k: _t(np.asarray(v)[t]) for t, k in enumerate(wk)},
          wk)
    r.add(bpath,
          lambda sd: np.stack([np.asarray(sd[k]) for k in bk]),
          lambda v: {k: np.asarray(v)[t] for t, k in enumerate(bk)},
          bk)


def _conv_rules(r: _Rules, kind: str, path, tp: str, *,
                heads: Optional[int] = None, num_bases: Optional[int] = None,
                num_aggrs: Optional[int] = None, towers: int = 4,
                att_shape: Optional[Tuple[int, int]] = None):
    """Rules for one conv layer; ``path`` is the conv module path
    (under 'params'), ``tp`` the torch key prefix (e.g. 'convs.0.')."""
    if kind == "egc":
        _egc_paper_rules(r, path, tp, num_bases)
    elif kind == "gcn":
        r.linear(path + ("lin",), tp, bias=False,
                 weight_names=("lin.weight", "weight"))
        r.direct(path + ("bias",), tp + "bias")
    elif kind == "gat":
        r.add(path + ("lin", "kernel"),
              lambda sd: _t(_get(sd, tp, "lin_src.weight", "lin_l.weight",
                                 "lin.weight")),
              lambda v: {tp + "lin_src.weight": _t(v)},
              [tp + n for n in ("lin_src.weight", "lin_l.weight",
                                "lin.weight")])
        r.add(path + ("att_src",),
              lambda sd: _get(sd, tp, "att_src", "att_l",
                              "att_i").reshape(att_shape),
              lambda v: {tp + "att_src": np.asarray(v)[None]},
              [tp + n for n in ("att_src", "att_l", "att_i")])
        r.add(path + ("att_dst",),
              lambda sd: _get(sd, tp, "att_dst", "att_r",
                              "att_j").reshape(att_shape),
              lambda v: {tp + "att_dst": np.asarray(v)[None]},
              [tp + n for n in ("att_dst", "att_r", "att_j")])
        r.direct(path + ("bias",), tp + "bias")
    elif kind == "gatv2":
        r.linear(path + ("lin_l",), tp + "lin_l.")
        r.linear(path + ("lin_r",), tp + "lin_r.")
        r.add(path + ("att",),
              lambda sd: _get(sd, tp, "att").reshape(att_shape),
              lambda v: {tp + "att": np.asarray(v)[None]},
              [tp + "att"])
        r.direct(path + ("bias",), tp + "bias")
    elif kind == "gin":
        r.direct(path + ("eps",), tp + "eps", shape=())
        # the conv's nn.Linear maps to a sibling MLP module — see _gin_mlp
    elif kind == "sage":
        r.linear(path + ("lin_l",), tp + "lin_l.")
        r.linear(path + ("lin_r",), tp + "lin_r.", bias=False)
    elif kind in ("mpnn-sum", "mpnn-max"):
        _tower_stack_rules(r, path + ("msg_kernel",), path + ("msg_bias",),
                           tp + "message_layer", towers)
        _tower_stack_rules(r, path + ("upd_kernel",), path + ("upd_bias",),
                           tp + "update_layer", towers)
        r.linear(path + ("lin",), tp + "lin.")
    elif kind == "pna":
        _tower_stack_rules(r, path + ("pre_kernel",), path + ("pre_bias",),
                           tp + "pre_nns", towers, inner="0.")
        _tower_stack_rules(r, path + ("post_kernel",), path + ("post_bias",),
                           tp + "post_nns", towers, inner="0.")
        r.linear(path + ("lin",), tp + "lin.")
    else:
        raise PortError(f"unknown conv kind {kind!r}")


def _mlp_rules(r: _Rules, path, tp: str, num_dense: int):
    """MLP module <-> reference mlp() Sequential: Dense_k at index 4k,
    BatchNorm at 4k+1 (reference ``experiments/utils.py:30-40``)."""
    for k in range(num_dense):
        r.linear(path + (f"Dense_{k}",), f"{tp}{4 * k}.")
        if k < num_dense - 1:
            r.batchnorm(path + (f"MaskedBatchNorm_{k}",),
                        ("batch_stats",) + path[1:] + (f"MaskedBatchNorm_{k}",),
                        f"{tp}{4 * k + 1}.")


def _module_indices(params: Dict[str, Any], cls: str) -> List[int]:
    out = []
    for k in params:
        if k == cls or k.startswith(cls + "_"):
            idx = k[len(cls) + 1:] if k != cls else "0"
            out.append(int(idx))
    return sorted(out)


def _count_dense(mlp_params: Dict[str, Any]) -> int:
    return len([k for k in mlp_params if k.startswith("Dense_")])


def build_rules(dataset: str, model_kind: str, variables: Dict[str, Any], *,
                heads: Optional[int] = None, bases: Optional[int] = None,
                aggrs: Optional[Tuple[str, ...]] = None,
                relations: Optional[Tuple[str, ...]] = None,
                node_types: Optional[Tuple[str, ...]] = None,
                featureless_types: Tuple[str, ...] = ()) -> _Rules:
    """Build the bidirectional rule set for (dataset, model_kind) given a
    template ``variables`` pytree (from ``model.init``)."""
    family = FAMILY[dataset]
    params = variables["params"]
    r = _Rules()

    if family == "rmag":
        _rmag_rules(r, params, model_kind, heads=heads, bases=bases,
                    relations=relations, node_types=node_types,
                    featureless_types=featureless_types)
        return r

    cls = _CONV_CLS[model_kind]
    conv_idx = _module_indices(params, cls)
    num_layers = len(conv_idx)

    # cifar's per-layer ModuleList leads with a (param-free) Dropout, so
    # its conv/BN sit at indices 1/2; zinc/hiv/code use [conv, BN, act] at
    # 0/1 (reference cifar/models.py:38-45 vs zinc/models.py:35-44 — found
    # by executing the reference nets, tests/test_reference_exec.py).
    conv_slot = 1 if dataset == "cifar" else 0

    def conv_prefix(i: int) -> str:
        return (f"graph_layers.{i}.{conv_slot}." if family == "batched"
                else f"convs.{i}.")

    def bn_prefix(i: int) -> str:
        return (f"graph_layers.{i}.{conv_slot + 1}." if family == "batched"
                else f"bns.{i}.")

    for i in conv_idx:
        name = f"{cls}_{i}"
        kwargs: Dict[str, Any] = {}
        if model_kind == "egc":
            if family == "mag":
                _egc_optimized_rules(r, ("params", name), conv_prefix(i),
                                     heads, bases, len(aggrs))
                continue
            kwargs["num_bases"] = bases
        if model_kind in ("gat", "gatv2"):
            att = params[name]["att_src" if model_kind == "gat" else "att"]
            kwargs["att_shape"] = tuple(np.shape(att))
        _conv_rules(r, model_kind, ("params", name), conv_prefix(i), **kwargs)

    # per-layer BatchNorm (mag has none)
    if family != "mag":
        for i in _module_indices(params, "MaskedBatchNorm"):
            r.batchnorm(("params", f"MaskedBatchNorm_{i}"),
                        ("batch_stats", f"MaskedBatchNorm_{i}"), bn_prefix(i))

    # GIN conv MLPs live as sibling MLP_{i} modules; any extra MLP is readout
    mlp_idx = _module_indices(params, "MLP")
    readout_mlps = list(mlp_idx)
    if model_kind == "gin":
        for i in conv_idx:
            r.linear(("params", f"MLP_{i}", "Dense_0"),
                     conv_prefix(i) + "nn.")
        readout_mlps = [m for m in mlp_idx if m >= num_layers]

    if family == "batched":
        for m in readout_mlps:
            _mlp_rules(r, ("params", f"MLP_{m}"), "mlp.",
                       _count_dense(params[f"MLP_{m}"]))
        _embedding_rules(r, dataset, params)
    elif family == "arxiv":
        r.linear(("params", "embed"), "embed.0.")
        r.linear(("params", "out"), "out.")

    return r


def _embedding_rules(r: _Rules, dataset: str, params: Dict[str, Any]):
    if dataset == "zinc":
        r.direct(("params", "embedding", "embedding"), "embedding.weight")
    elif dataset == "cifar":
        r.linear(("params", "embedding"), "embedding.")
    elif dataset == "hiv":
        emb = params["embedding"]
        for k in sorted(emb, key=lambda s: int(s.rsplit("_", 1)[1])):
            i = int(k.rsplit("_", 1)[1])
            r.direct(("params", "embedding", k, "embedding"),
                     f"embedding.atom_embedding_list.{i}.weight")
    elif dataset == "code":
        for ours, theirs in (("type", "type_encoder"),
                             ("attr", "attribute_encoder"),
                             ("depth", "depth_encoder")):
            r.direct(("params", "embedding", ours, "embedding"),
                     f"embedding.{theirs}.weight")
        # 5 token heads fuse into one Dense (reference code/models.py:95-98)
        tp = params["token_predictors"]["kernel"]
        hidden, fused = np.shape(tp)
        # fixed S=5 in the reference (code/models.py:95-98)
        seq_len = 5
        if fused % seq_len or hidden <= 0:
            raise PortError(f"token_predictors kernel {tp.shape} does not "
                            f"split into {seq_len} heads")

        def imp_k(sd):
            return np.concatenate(
                [_t(sd[f"token_predictors.{s}.weight"])
                 for s in range(seq_len)], axis=1)

        def exp_k(v):
            chunks = np.split(np.asarray(v), seq_len, axis=1)
            return {f"token_predictors.{s}.weight": _t(c)
                    for s, c in enumerate(chunks)}

        def imp_b(sd):
            return np.concatenate(
                [np.asarray(sd[f"token_predictors.{s}.bias"])
                 for s in range(seq_len)])

        def exp_b(v):
            chunks = np.split(np.asarray(v), seq_len)
            return {f"token_predictors.{s}.bias": c
                    for s, c in enumerate(chunks)}

        keys = [f"token_predictors.{s}.{w}" for s in range(seq_len)
                for w in ("weight", "bias")]
        r.add(("params", "token_predictors", "kernel"), imp_k, exp_k, keys)
        r.add(("params", "token_predictors", "bias"), imp_b, exp_b, [])


def _rmag_rules(r: _Rules, params, model_kind: str, *, heads, bases,
                relations, node_types, featureless_types):
    """REGCNet <-> reference REGC/RGCN (rmag/models.py:32-212, bug fixed).

    relations: our rel keys ("src__rel__dst"); torch uses "src_rel_dst"."""
    if relations is None or node_types is None:
        raise PortError("rmag porting needs relations= and node_types=")

    def tkey(rel: str) -> str:
        from egc_tpu.graph.hetero import split_rel_key
        return "_".join(split_rel_key(rel))

    for t in featureless_types:
        r.direct(("params", f"emb_{t}"), f"embs.{t}")

    regc_idx = _module_indices(params, "REGConv")
    rgcn_idx = _module_indices(params, "RGCNConv")
    n_inner = len(regc_idx) if model_kind in ("egc", "regc") else \
        len(rgcn_idx) - 1

    for i in regc_idx:
        p, tp = ("params", f"REGConv_{i}"), f"convs.{i}."
        r.add(p + ("bases", "kernel"),
              lambda sd, tp=tp: np.asarray(sd[tp + "bases_weight"]),
              lambda v, tp=tp: {tp + "bases_weight": np.asarray(v)},
              [tp + "bases_weight"])
        for t in node_types:
            r.linear(p + (f"root_comb_{t}",), f"{tp}root_combs.{t}.")
        for rel in relations:
            r.linear(p + (f"rel_comb_{rel}",), f"{tp}rel_combs.{tkey(rel)}.")

    for j in rgcn_idx:
        # our RGCNConv_j: conv index j when pure-RGCN stack, else the final
        # layer at torch index n_inner + j
        i = j if model_kind in ("rgcn",) else n_inner + j
        p, tp = ("params", f"RGCNConv_{j}"), f"convs.{i}."
        for t in node_types:
            r.linear(p + (f"root_{t}",), f"{tp}root_lins.{t}.")
        for rel in relations:
            r.linear(p + (f"rel_{rel}",), f"{tp}rel_lins.{tkey(rel)}.",
                     bias=False)


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    if path[-1] not in node:
        raise PortError(f"template has no leaf at {'/'.join(path)}")
    node[path[-1]] = value


def _get_path(tree: Dict[str, Any], path: Tuple[str, ...]):
    node = tree
    for k in path:
        node = node[k]
    return node


def _unfreeze(variables):
    """A copy of ``variables`` whose nested dicts may be assigned to."""
    import jax
    return jax.tree.map(lambda x: x, dict(variables))


def import_model_state(dataset: str, model_kind: str,
                       torch_sd: Dict[str, np.ndarray],
                       variables: Dict[str, Any], *, strict: bool = True,
                       **spec) -> Dict[str, Any]:
    """Port a reference torch state dict into a template ``variables``
    pytree (from ``model.init``); returns a new variables dict.

    ``spec``: heads/bases/aggrs for EGC kinds; relations/node_types/
    featureless_types for rmag. ``strict`` errors on unconsumed torch keys
    (num_batches_tracked and duplicate-share aliases excepted).
    """
    rules = build_rules(dataset, model_kind, variables, **spec)
    out = _unfreeze(variables)
    for path, fn in rules.imports:
        v = np.asarray(fn(torch_sd))
        tmpl = np.asarray(_get_path(variables, path))
        if v.shape != tmpl.shape:
            raise PortError(f"{'/'.join(path)}: torch value has shape "
                            f"{v.shape}, template expects {tmpl.shape}")
        _set_path(out, path, v.astype(tmpl.dtype))
    if strict:
        consumed = set(rules.consumed)
        # PyG shares lin_dst with lin_src for GAT over int in_channels; both
        # aliases appear in the state dict. Tolerate ONLY true aliases
        # (value-equal to the consumed lin_src/lin_l counterpart) — a
        # checkpoint carrying a distinct lin_dst weight must fail loudly,
        # not load with silently-dropped weights.
        leftovers = []
        for k in torch_sd:
            if k in consumed or k.endswith("num_batches_tracked"):
                continue
            if ".lin_dst." in k:
                for alias in (".lin_src.", ".lin_l."):
                    ref = k.replace(".lin_dst.", alias)
                    if ref in torch_sd and np.array_equal(
                            np.asarray(torch_sd[k]),
                            np.asarray(torch_sd[ref])):
                        break
                else:
                    raise PortError(
                        f"{k}: lin_dst is not value-equal to its "
                        "lin_src/lin_l counterpart — distinct destination "
                        "weights are not supported by this port")
                continue
            leftovers.append(k)
        if leftovers:
            raise PortError(f"unmapped torch keys: {leftovers[:10]}"
                            f"{'...' if len(leftovers) > 10 else ''}")
    return out


def restore_pretrained_pt(config, dataset: str, pt_path, *, seed: int = 0,
                          data=None):
    """Restore a reference torch ``checkpoint.pt`` into this framework's
    (model, TrainState, data) for evaluation — this framework's counterpart of
    the reference's ``load_pretrained`` (``experiments/utils.py:69-79``):
    the config supplies architecture (already validated against the
    pretrained registry), the torch file supplies weights."""
    from egc_tpu.utils import torch_pt

    hp = config.default_hparams()
    if data is None:
        data = config.data(hp)
    model = config.model(hp)
    state = config.init_state(model, hp, data, seed)
    sd = torch_pt.load_state_dict(pt_path)
    kind = config.model_kind
    spec: Dict[str, Any] = {}
    if kind == "egc":
        # batched configs carry the spec on a ConvSpec; full-graph configs
        # carry it directly
        conv = getattr(config, "conv", None)
        heads = getattr(config, "heads", None) or conv.heads
        bases = getattr(config, "bases", None) or conv.bases
        aggrs = getattr(config, "aggrs", None) or \
            (conv.aggrs if conv is not None else None)
        spec = dict(heads=heads, bases=bases,
                    aggrs=tuple(aggrs or ("symnorm",)))
    variables: Dict[str, Any] = {"params": state.params}
    bs = getattr(state, "batch_stats", None)
    if bs:
        variables["batch_stats"] = bs
    ported = import_model_state(dataset, kind, sd, variables, **spec)
    state = state.replace(
        params=ported["params"],
        batch_stats=ported.get("batch_stats", bs))
    return model, state, data


def export_model_state(dataset: str, model_kind: str,
                       variables: Dict[str, Any],
                       **spec) -> "OrderedDict[str, np.ndarray]":
    """Inverse of :func:`import_model_state`: produce a reference-named
    torch state dict (numpy values) from our variables pytree."""
    rules = build_rules(dataset, model_kind, variables, **spec)
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for path, fn in rules.exports:
        v = np.asarray(_get_path(variables, path))
        for k, tv in fn(v).items():
            out[k] = np.asarray(tv)
    # emit BN bookkeeping keys torch expects
    for k in list(out):
        if k.endswith("running_mean"):
            out[k[: -len("running_mean")] + "num_batches_tracked"] = \
                np.asarray(0, np.int64)
    return out
