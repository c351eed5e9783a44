"""Reference torch-checkpoint import: reader + weight-layout porting.

Gates (VERDICT round-2 item 1):
- the numpy-only ``torch_pt`` reader handles both torch serialization
  formats, all common dtypes, strided tensor views, and the reference's
  trial payload shape (``experiments/exp_config.py:31-38``);
- every (dataset, model) family round-trips export -> torch.save ->
  numpy-load -> import EXACTLY (leaves and forwards bit-equal);
- layout shims reproduce the reference forward math from torch-layout
  weights (numpy oracles written from ``experiments/layers.py:89-140`` and
  ``experiments/optimized_layers.py:177-249``), i.e. a fabricated
  reference-format checkpoint loads and reproduces the recorded forward.
"""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from egc_tpu.graph import Graph
from egc_tpu.graph.hetero import hetero_from_numpy, rel_key
from egc_tpu.models.nets import (
    ZincNet, CifarNet, HIVNet, ArxivNet, CodeNet, MagNet, ConvSpec,
)
from egc_tpu.nn.conv.hetero import REGCNet
from egc_tpu.utils import torch_pt
from egc_tpu.exp.weight_port import (
    import_model_state, export_model_state, PortError,
)

torch = pytest.importorskip("torch")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def tiny_graph(rng, n=12, e=30, feat=None, kind="float"):
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    if kind == "zinc":
        nodes = rng.integers(0, 28, (n, 1)).astype(np.int32)
    elif kind == "hiv":
        from egc_tpu.models.encoders import ATOM_FEATURE_DIMS
        nodes = np.stack([rng.integers(0, d, n) for d in ATOM_FEATURE_DIMS],
                         axis=1).astype(np.int32)
    elif kind == "code":
        nodes = np.stack([rng.integers(0, 9, n), rng.integers(0, 11, n),
                          rng.integers(0, 9, n)], axis=1).astype(np.int32)
    else:
        nodes = rng.normal(size=(n, feat)).astype(np.float32)
    return jax.tree.map(jnp.asarray, Graph.from_coo(nodes, s, r))


def save_load(sd_np, tmp_path, legacy=False, wrap=True):
    """np state dict -> real torch.save file -> numpy-only reader."""
    sd_t = collections.OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(v)))
        for k, v in sd_np.items())
    payload = {"model": sd_t, "opt": {"state": {}, "param_groups": []},
               "lr_scheduler": {"mode": "min"}, "hparams": {"lr": 1e-3}} \
        if wrap else sd_t
    p = tmp_path / ("ck_legacy.pt" if legacy else "ck.pt")
    torch.save(payload, str(p),
               _use_new_zipfile_serialization=not legacy)
    return torch_pt.load_state_dict(p)


def assert_tree_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = {jax.tree_util.keystr(p): v
          for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert len(la) == len(lb)
    for p, v in la:
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(lb[jax.tree_util.keystr(p)]),
                                      err_msg=jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("legacy", [False, True])
def test_reader_formats_dtypes_views(tmp_path, legacy):
    g = torch.Generator().manual_seed(0)
    sd = collections.OrderedDict()
    sd["w.f32"] = torch.randn(4, 3, generator=g)
    sd["w.f64"] = torch.randn(2, 5, generator=g).double()
    sd["w.f16"] = torch.randn(3, 3, generator=g).half()
    sd["w.i64"] = torch.arange(7)
    sd["w.i32"] = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    sd["w.bool"] = torch.tensor([True, False, True])
    sd["w.u8"] = torch.arange(5, dtype=torch.uint8)
    sd["w.scalar"] = torch.tensor(2.5)
    sd["w.strided"] = torch.randn(6, 4, generator=g).t()  # transposed view
    sd["w.slice"] = torch.randn(8, 8, generator=g)[2:5, 1:7]
    p = tmp_path / "t.pt"
    torch.save({"model": sd, "hparams": {"a": [1, 2]}}, str(p),
               _use_new_zipfile_serialization=not legacy)
    got = torch_pt.load_state_dict(p)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        ref = v.detach().numpy()
        assert got[k].shape == tuple(ref.shape), k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
    full = torch_pt.load(p)
    assert full["hparams"] == {"a": [1, 2]}


def test_reader_bare_state_dict(tmp_path):
    sd = {"x": torch.ones(3)}
    p = tmp_path / "bare.pt"
    torch.save(sd, str(p))
    got = torch_pt.load_state_dict(p)
    np.testing.assert_array_equal(got["x"], np.ones(3, np.float32))


class _WeirdHparam:
    """Module-level so torch.save can pickle it; the reader sees an unknown
    global (this module won't be importable under the same name when the
    unpickler resolves it via find_class stubs)."""

    def __init__(self):
        self.x = 3


def test_reader_tolerates_stub_objects(tmp_path):
    # hparams with arbitrary objects (the reference pickles whole hparam
    # dicts) must not break tensor extraction
    p = tmp_path / "s.pt"
    torch.save({"model": {"w": torch.zeros(2)},
                "hparams": {"obj": _WeirdHparam()}}, str(p))
    got = torch_pt.load_state_dict(p)
    assert "w" in got


# ---------------------------------------------------------------------------
# round-trips: export -> torch.save -> load -> import must be exact
# ---------------------------------------------------------------------------

def _roundtrip(dataset, kind, model, g, tmp_path, rng, legacy=False, **spec):
    variables = model.init(jax.random.PRNGKey(0), g, train=False)
    # randomize batch_stats so BN porting is non-trivial
    if "batch_stats" in variables:
        variables = jax.tree.map(lambda x: x, dict(variables))
        stats = jax.tree.map(
            lambda x: jnp.asarray(
                rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)),
            variables["batch_stats"])
        variables["batch_stats"] = stats
    sd = export_model_state(dataset, kind, variables, **spec)
    loaded = save_load(sd, tmp_path, legacy=legacy)
    fresh = model.init(jax.random.PRNGKey(1), g, train=False)
    ported = import_model_state(dataset, kind, loaded, fresh, **spec)
    assert_tree_equal(variables, ported)
    out_a = model.apply(variables, g, train=False)
    out_b = model.apply(ported, g, train=False)
    np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_b))


def test_roundtrip_zinc_egc_m(tmp_path, rng):
    m = ZincNet(conv=ConvSpec("egc", heads=4, bases=4,
                              aggrs=("add", "std", "max")),
                hidden_dim=8, num_layers=2)
    _roundtrip("zinc", "egc", m, tiny_graph(rng, kind="zinc"), tmp_path, rng,
               heads=4, bases=4, aggrs=("add", "std", "max"))


def test_roundtrip_zinc_gatv2_legacy_format(tmp_path, rng):
    m = ZincNet(conv=ConvSpec("gatv2", heads=4), hidden_dim=8, num_layers=2)
    _roundtrip("zinc", "gatv2", m, tiny_graph(rng, kind="zinc"), tmp_path,
               rng, legacy=True)


def test_roundtrip_cifar_egc_s_softmax(tmp_path, rng):
    m = CifarNet(conv=ConvSpec("egc", heads=2, bases=4, softmax=True,
                               aggrs=("symadd",)),
                 hidden_dim=8, num_layers=2)
    _roundtrip("cifar", "egc", m, tiny_graph(rng, feat=5), tmp_path, rng,
               heads=2, bases=4, aggrs=("symadd",))


@pytest.mark.parametrize("kind", ["gcn", "gin", "sage", "mpnn-max"])
def test_roundtrip_hiv(tmp_path, rng, kind):
    m = HIVNet(conv=ConvSpec(kind), hidden_dim=8, num_layers=2)
    _roundtrip("hiv", kind, m, tiny_graph(rng, kind="hiv"), tmp_path, rng)


@pytest.mark.parametrize("kind", ["gat", "gatv2", "pna", "mpnn-sum"])
def test_roundtrip_arxiv(tmp_path, rng, kind):
    m = ArxivNet(conv=ConvSpec(kind, heads=4, avg_log_deg=1.2),
                 hidden_dim=8, num_layers=2, num_features=16)
    _roundtrip("arxiv", kind, m, tiny_graph(rng, feat=16), tmp_path, rng)


def test_roundtrip_arxiv_egc_s(tmp_path, rng):
    m = ArxivNet(conv=ConvSpec("egc", heads=2, bases=4, softmax=True,
                               aggrs=("symadd",)),
                 hidden_dim=8, num_layers=3, num_features=16)
    _roundtrip("arxiv", "egc", m, tiny_graph(rng, feat=16), tmp_path, rng,
               heads=2, bases=4, aggrs=("symadd",))


def test_roundtrip_code_egc_m(tmp_path, rng):
    m = CodeNet(conv=ConvSpec("egc", heads=4, bases=4,
                              aggrs=("symadd", "min", "max")),
                hidden_dim=8, num_layers=2, vocab_size=7, seq_len=5,
                num_nodeattributes=11, max_depth=8)
    _roundtrip("code", "egc", m, tiny_graph(rng, kind="code"), tmp_path, rng,
               heads=4, bases=4, aggrs=("symadd", "min", "max"))


def test_roundtrip_code_gin(tmp_path, rng):
    m = CodeNet(conv=ConvSpec("gin"), hidden_dim=8, num_layers=2,
                vocab_size=7, seq_len=5, num_nodeattributes=11, max_depth=8)
    _roundtrip("code", "gin", m, tiny_graph(rng, kind="code"), tmp_path, rng)


def test_roundtrip_mag(tmp_path, rng):
    m = MagNet(hidden_dim=8, num_layers=2, heads=2, bases=3,
               aggrs=("symnorm", "max"), out_rounded=8, out_true=5)
    _roundtrip("mag", "egc", m, tiny_graph(rng, feat=6), tmp_path, rng,
               heads=2, bases=3, aggrs=("symnorm", "max"))


def _tiny_hetero(rng):
    nodes = {"a": rng.normal(size=(5, 6)).astype(np.float32),
             "b": np.zeros((4, 6), np.float32)}
    edges = {
        rel_key("a", "to", "b"): (np.array([0, 1, 2, 0], np.int32),
                                  np.array([0, 0, 1, 3], np.int32)),
        rel_key("b", "back", "a"): (np.array([0, 1], np.int32),
                                    np.array([2, 4], np.int32)),
    }
    return jax.tree.map(jnp.asarray, hetero_from_numpy(nodes, edges)), edges


@pytest.mark.parametrize("use_egc", [True, False])
def test_roundtrip_rmag(tmp_path, rng, use_egc):
    hg, edges = _tiny_hetero(rng)
    m = REGCNet(hidden_dim=8, num_layers=2, use_egc=use_egc, heads=2,
                bases=2, num_classes=5, in_features=6,
                featureless_types=("b",), target_type="a")
    variables = m.init(jax.random.PRNGKey(0), hg, train=False)
    kind = "regc" if use_egc else "rgcn"
    spec = dict(relations=tuple(sorted(edges)), node_types=("a", "b"),
                featureless_types=("b",))
    sd = export_model_state("rmag", kind, variables, **spec)
    loaded = save_load(sd, tmp_path)
    fresh = m.init(jax.random.PRNGKey(1), hg, train=False)
    ported = import_model_state("rmag", kind, loaded, fresh, **spec)
    assert_tree_equal(variables, ported)
    np.testing.assert_array_equal(
        np.asarray(m.apply(variables, hg, train=False)),
        np.asarray(m.apply(ported, hg, train=False)))


def test_import_rejects_wrong_shapes(tmp_path, rng):
    m = ZincNet(conv=ConvSpec("gatv2", heads=4), hidden_dim=8, num_layers=2)
    g = tiny_graph(rng, kind="zinc")
    variables = m.init(jax.random.PRNGKey(0), g, train=False)
    sd = export_model_state("zinc", "gatv2", variables)
    sd["embedding.weight"] = sd["embedding.weight"][:, :4]
    with pytest.raises(PortError):
        import_model_state("zinc", "gatv2", sd, variables)


def test_import_strict_flags_leftovers(tmp_path, rng):
    m = ZincNet(conv=ConvSpec("gatv2", heads=4), hidden_dim=8, num_layers=2)
    g = tiny_graph(rng, kind="zinc")
    variables = m.init(jax.random.PRNGKey(0), g, train=False)
    sd = export_model_state("zinc", "gatv2", variables)
    sd["graph_layers.0.0.mystery"] = np.zeros(3)
    with pytest.raises(PortError, match="unmapped"):
        import_model_state("zinc", "gatv2", sd, variables)
    import_model_state("zinc", "gatv2", sd, variables, strict=False)


# ---------------------------------------------------------------------------
# layout oracles: torch-layout weights must reproduce the reference math
# ---------------------------------------------------------------------------

def _gcn_norm_np(s, r, n):
    """gcn_norm(A + I), improved=False: w_ij = 1/sqrt(d_i d_j) with degrees
    counted after adding self loops (PyG gcn_conv.gcn_norm). Pre-existing
    loop edges are DEDUPED into the single added loop — verified against the
    executing reference code (tests/test_reference_exec.py)."""
    keep = s != r
    s2 = np.concatenate([s[keep], np.arange(n)])
    r2 = np.concatenate([r[keep], np.arange(n)])
    deg = np.zeros(n)
    np.add.at(deg, r2, 1.0)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    w = dinv[s2] * dinv[r2]
    return s2, r2, w


def _agg_np(vals_src, s, r, n, how, include_self, vals_self=None):
    f = vals_src.shape[1]
    if how == "symnorm":
        s2, r2, w = _gcn_norm_np(s, r, n)
        out = np.zeros((n, f))
        np.add.at(out, r2, w[:, None] * vals_src[s2])
        return out
    ss, rr = (np.concatenate([s, np.arange(n)]),
              np.concatenate([r, np.arange(n)])) if include_self else (s, r)
    if how in ("sum", "add"):
        out = np.zeros((n, f))
        np.add.at(out, rr, vals_src[ss])
        return out
    if how == "max":
        out = np.full((n, f), -np.inf)
        np.maximum.at(out, rr, vals_src[ss])
        out[np.isinf(out)] = 0.0
        return out
    if how == "min":
        return -_agg_np(-vals_src, s, r, n, "max", include_self)
    if how == "mean":
        cnt = np.zeros(n)
        np.add.at(cnt, rr, 1.0)
        out = np.zeros((n, f))
        np.add.at(out, rr, vals_src[ss])
        return out / np.maximum(cnt, 1)[:, None]
    if how in ("var", "std"):
        m = _agg_np(vals_src, s, r, n, "mean", include_self)
        m2 = _agg_np(vals_src ** 2, s, r, n, "mean", include_self)
        v = m2 - m * m
        return np.sqrt(np.maximum(v, 0) + 1e-5) if how == "std" else v
    raise ValueError(how)


def test_mag_import_matches_reference_math(tmp_path, rng):
    """Optimized EGConv (reference optimized_layers.py:177-249): fabricated
    torch-layout weights -> import -> our MagNet forward must equal a numpy
    implementation of the reference math (exercises the aggregator-major ->
    bases-major comb permutation and the fused bases layout)."""
    H, B = 2, 3
    aggrs = ("symnorm", "max", "std")
    A = len(aggrs)
    hid, out_r, out_t, feat, n, e = 8, 8, 5, 6, 10, 24
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, feat)).astype(np.float32)

    sd = {}
    dims = [(feat, hid), (hid, out_r)]
    for i, (ci, co) in enumerate(dims):
        L = co // H
        sd[f"convs.{i}.bases_weight"] = \
            rng.normal(size=(ci, L * B)).astype(np.float32)
        sd[f"convs.{i}.comb_weight.weight"] = \
            rng.normal(size=(H * B * A, ci)).astype(np.float32)
        sd[f"convs.{i}.comb_weight.bias"] = \
            rng.normal(size=(H * B * A,)).astype(np.float32)
        sd[f"convs.{i}.bias"] = rng.normal(size=(co,)).astype(np.float32)

    # numpy reference forward (optimized_layers.py:177-210 math)
    def conv_np(xin, i, co):
        L = co // H
        bases = xin @ sd[f"convs.{i}.bases_weight"]          # [n, B*L]
        w = xin @ sd[f"convs.{i}.comb_weight.weight"].T + \
            sd[f"convs.{i}.comb_weight.bias"]                 # [n, H*B*A]
        agg = np.stack([_agg_np(bases, s, r, n, a, include_self=True)
                        for a in aggrs], axis=1)              # [n, A, B*L]
        agg = agg.reshape(n, A * B, L)
        w = w.reshape(n, H, B * A)
        z = np.einsum("nhk,nkl->nhl", w, agg).reshape(n, co)
        return z + sd[f"convs.{i}.bias"]

    href = conv_np(x, 0, hid)
    href = np.maximum(href, 0.0)
    zref = conv_np(href, 1, out_r)[:, :out_t]
    zref = zref - zref.max(axis=1, keepdims=True)
    ref = zref - np.log(np.sum(np.exp(zref), axis=1, keepdims=True))

    m = MagNet(hidden_dim=hid, num_layers=2, heads=H, bases=B, aggrs=aggrs,
               out_rounded=out_r, out_true=out_t)
    g = jax.tree.map(jnp.asarray, Graph.from_coo(x, s, r))
    loaded = save_load(sd, tmp_path)
    variables = import_model_state(
        "mag", "egc", loaded,
        m.init(jax.random.PRNGKey(0), g, train=False),
        heads=H, bases=B, aggrs=aggrs)
    got = np.asarray(m.apply(variables, g, train=False))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_arxiv_egc_import_matches_reference_math(tmp_path, rng):
    """Paper EfficientGraphConv inside ArxivNet (layers.py:89-140 +
    norm_models.py:14-47): fabricated torch checkpoint -> import -> forward
    must equal the numpy reference (eval mode, running BN stats)."""
    H, B = 2, 2
    aggrs = ("symadd", "max")
    A = len(aggrs)
    hid, feat, ncls, n, e, layers = 8, 6, 5, 10, 24, 2
    L = hid // H
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, feat)).astype(np.float32)

    sd = {}
    sd["embed.0.weight"] = rng.normal(size=(hid, feat)).astype(np.float32)
    sd["embed.0.bias"] = rng.normal(size=(hid,)).astype(np.float32)
    for i in range(layers):
        for b in range(B):
            sd[f"convs.{i}.bases_weight.{b}"] = \
                rng.normal(size=(hid, L)).astype(np.float32)
        sd[f"convs.{i}.comb_weights.weight"] = \
            rng.normal(size=(H * B * A, hid)).astype(np.float32)
        sd[f"convs.{i}.comb_weights.bias"] = \
            rng.normal(size=(H * B * A,)).astype(np.float32)
        sd[f"convs.{i}.bias"] = rng.normal(size=(hid,)).astype(np.float32)
        sd[f"bns.{i}.weight"] = rng.uniform(
            0.5, 1.5, hid).astype(np.float32)
        sd[f"bns.{i}.bias"] = rng.normal(size=(hid,)).astype(np.float32)
        sd[f"bns.{i}.running_mean"] = rng.normal(size=(hid,)).astype(
            np.float32)
        sd[f"bns.{i}.running_var"] = rng.uniform(
            0.5, 1.5, hid).astype(np.float32)
    sd["out.weight"] = rng.normal(size=(ncls, hid)).astype(np.float32)
    sd["out.bias"] = rng.normal(size=(ncls,)).astype(np.float32)

    def egc_paper_np(xin, i):
        bases = np.concatenate(
            [xin @ sd[f"convs.{i}.bases_weight.{b}"] for b in range(B)],
            axis=1)                                          # [n, B*L]
        # paper mode: self loops ONLY inside symadd's gcn_norm
        y = np.stack([_agg_np(bases, s, r, n, "symnorm" if a == "symadd"
                              else a, include_self=False)
                      for a in aggrs], axis=2)               # [n, B*L, A]
        y = y.reshape(n, B, L, A)
        w = (xin @ sd[f"convs.{i}.comb_weights.weight"].T +
             sd[f"convs.{i}.comb_weights.bias"]).reshape(n, H, B, A)
        z = np.einsum("nhba,nbla->nhl", w, y).reshape(n, hid)
        return z + sd[f"convs.{i}.bias"]

    h = x @ sd["embed.0.weight"].T + sd["embed.0.bias"]
    for i in range(layers):
        identity = h
        z = egc_paper_np(h, i)
        z = (z - sd[f"bns.{i}.running_mean"]) / \
            np.sqrt(sd[f"bns.{i}.running_var"] + 1e-5) * \
            sd[f"bns.{i}.weight"] + sd[f"bns.{i}.bias"]
        h = np.maximum(z, 0.0) + identity
    z = h @ sd["out.weight"].T + sd["out.bias"]
    z = z - z.max(axis=1, keepdims=True)
    ref = z - np.log(np.sum(np.exp(z), axis=1, keepdims=True))

    m = ArxivNet(conv=ConvSpec("egc", heads=H, bases=B, aggrs=aggrs),
                 hidden_dim=hid, num_layers=layers, num_features=feat,
                 num_classes=ncls)
    g = jax.tree.map(jnp.asarray, Graph.from_coo(x, s, r))
    loaded = save_load(sd, tmp_path)
    variables = import_model_state(
        "arxiv", "egc", loaded,
        m.init(jax.random.PRNGKey(0), g, train=False),
        heads=H, bases=B, aggrs=aggrs)
    got = np.asarray(m.apply(variables, g, train=False))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_restore_pretrained_pt_end_to_end(tmp_path, rng):
    """Full --pretrained flow: a reference-format checkpoint.pt restores
    through a real experiment config and reproduces the test metric of the
    state it was exported from."""
    from main import build_config
    from egc_tpu.exp.weight_port import restore_pretrained_pt

    config = build_config("zinc", "egc", hidden=8, heads=4, bases=2,
                          aggrs="add,max", num_samples=1, synthetic=True)
    hp = config.default_hparams()
    data = config.data(hp)
    model = config.model(hp)
    state = config.init_state(model, hp, data, seed=0)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    sd = export_model_state("zinc", "egc", variables, heads=4, bases=2,
                            aggrs=("add", "max"))
    sd_t = collections.OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(v)))
        for k, v in sd.items())
    torch.save({"model": sd_t, "opt": {}, "hparams": {"lr": 1e-3},
                "lr_scheduler": {}}, str(tmp_path / "checkpoint.pt"))

    model2, state2, data2 = restore_pretrained_pt(
        config, "zinc", tmp_path / "checkpoint.pt", data=data)
    ref = config.test(model, state, data)
    got = config.test(model2, state2, data2)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)


def test_gat_alias_names_accepted(tmp_path, rng):
    """Older PyG checkpoints name GAT params lin_l/att_l/att_r."""
    m = ArxivNet(conv=ConvSpec("gat", heads=4), hidden_dim=8, num_layers=2,
                 num_features=16)
    g = tiny_graph(rng, feat=16)
    variables = m.init(jax.random.PRNGKey(0), g, train=False)
    sd = export_model_state("arxiv", "gat", variables)
    renamed = {}
    for k, v in sd.items():
        k = k.replace(".lin_src.", ".lin_l.").replace(".att_src", ".att_l")
        k = k.replace(".att_dst", ".att_r")
        renamed[k] = v
    loaded = save_load(renamed, tmp_path)
    ported = import_model_state("arxiv", "gat", loaded,
                                m.init(jax.random.PRNGKey(1), g,
                                       train=False))
    assert_tree_equal(variables, ported)


def test_gat_lin_dst_alias_tolerated_distinct_rejected(tmp_path, rng):
    """PyG GAT over int in_channels registers lin_dst as an alias of
    lin_src (both keys, same tensor) — tolerated. A checkpoint with a
    DISTINCT lin_dst weight must raise, not silently drop it (r4 review
    finding)."""
    m = ArxivNet(conv=ConvSpec("gat", heads=4), hidden_dim=8, num_layers=2,
                 num_features=16)
    g = tiny_graph(rng, feat=16)
    variables = m.init(jax.random.PRNGKey(0), g, train=False)
    sd = export_model_state("arxiv", "gat", variables)
    src_keys = [k for k in sd if ".lin_src." in k]
    assert src_keys
    aliased = dict(sd)
    for k in src_keys:
        aliased[k.replace(".lin_src.", ".lin_dst.")] = sd[k]
    tmpl = m.init(jax.random.PRNGKey(1), g, train=False)
    ported = import_model_state("arxiv", "gat",
                                save_load(aliased, tmp_path), tmpl)
    assert_tree_equal(variables, ported)
    distinct = dict(aliased)
    k0 = src_keys[0].replace(".lin_src.", ".lin_dst.")
    distinct[k0] = np.asarray(distinct[k0]) + 1.0
    with pytest.raises(Exception, match="lin_dst"):
        import_model_state("arxiv", "gat", save_load(distinct, tmp_path),
                           tmpl)
