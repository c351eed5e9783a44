"""Executed-reference parity: the ACTUAL reference layer code as oracle.

VERDICT r4 item 1. Every earlier parity test compares against numpy
transcriptions of the reference math; these tests instead EXECUTE the
reference sources (``/root/reference/experiments/layers.py``,
``optimized_layers.py``, ``rmag/models.py``) under the pure-torch PyG shim
(:mod:`pyg_shim`) and gate this framework's layers on forward AND backward
(input + every parameter gradient) allclose against them, across the
reference's tuned aggregator sets and weighting variants.

Weight transfer uses the same :mod:`egc_tpu.exp.weight_port` rules the
pretrained-checkpoint importer uses, so a divergence here implicates either
the layer math or the porting layout — both things this suite must gate.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import pyg_shim  # noqa: E402
from egc_tpu.graph import Graph  # noqa: E402
from egc_tpu.graph.hetero import hetero_from_numpy, rel_key  # noqa: E402
from egc_tpu.nn.conv.egc import EGConv  # noqa: E402
from egc_tpu.nn.conv.mpnn import MPNNConv  # noqa: E402
from egc_tpu.nn.conv.hetero import RGCNConv, REGConv  # noqa: E402
from egc_tpu.exp import weight_port as wp  # noqa: E402


FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=5e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def reference_tree():
    """Every test here executes the reference's sources: skip (decided at
    run time, before the module fixtures that load them) when their tree
    is not on disk."""
    if not os.path.isdir(pyg_shim.REFERENCE_ROOT):
        pytest.skip(f"reference sources not found at "
                    f"{pyg_shim.REFERENCE_ROOT}")


@pytest.fixture(scope="module")
def ref_layers():
    return pyg_shim.load_reference("experiments/layers.py")


@pytest.fixture(scope="module")
def ref_opt():
    return pyg_shim.load_reference("experiments/optimized_layers.py")


@pytest.fixture(scope="module")
def ref_rmag():
    return pyg_shim.load_reference("experiments/rmag/models.py")


def rand_graph(rng, n=30, e=85, with_loops=True):
    """Random COO graph; node 0 is isolated (empty-segment case).

    The isolated node is NOT the max-indexed one: the reference's
    optimized path calls ``add_remaining_self_loops(edge_index)`` without
    ``num_nodes`` (optimized_layers.py:163), inferring the node count from
    the max edge index — a trailing isolated node would get no self-loop
    there, an indexing quirk (SURVEY §7.3 class) this framework does not
    replicate.

    ``with_loops`` plants an existing self-loop (the reference's
    ``gcn_norm``/``add_remaining_self_loops`` dedup case — symnorm paths
    handle it exactly). The ``self_loop_mode="all"`` non-symnorm fold
    instead documents loop-free inputs as a precondition (ingestion strips
    loops; see EGConv docstring), so those cases pass ``with_loops=False``.

    Edges are DEDUPED: duplicate (s, r) pairs carry identical messages, so
    max/min gradients hit ties there — and tie cotangent routing is
    implementation-defined even between the reference's own backends
    (torch ``scatter_reduce`` splits among ties, torch_scatter's CUDA
    kernel picks one argmax, this framework routes the full cotangent to
    every tie). Reference datasets carry no duplicate edges.
    """
    s = rng.integers(1, n, e).astype(np.int64)
    r = rng.integers(1, n, e).astype(np.int64)
    s[1], r[1] = n - 1, 1   # ensure the max index appears
    if with_loops:
        s[0] = r[0] = 3  # existing self-loop
    else:
        loop = s == r
        r[loop] = 1 + (s[loop] % (n - 1))
        loop = s == r
        r[loop] = 1 + ((s[loop] + 1) % (n - 1))
    pair = np.unique(np.stack([s, r], axis=1), axis=0)
    return (np.ascontiguousarray(pair[:, 0]),
            np.ascontiguousarray(pair[:, 1]))


def apply_import_rules(rules, sd, variables):
    """Layer-scope version of weight_port.import_model_state."""
    out = wp._unfreeze(variables)
    for path, fn in rules.imports:
        v = np.asarray(fn(sd))
        tmpl = np.asarray(wp._get_path(variables, path))
        assert v.shape == tmpl.shape, (path, v.shape, tmpl.shape)
        wp._set_path(out, path, v.astype(tmpl.dtype))
    return out


def torch_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def torch_grads(module):
    return {k: p.grad.detach().numpy()
            for k, p in module.named_parameters()}


def check_param_grads(rules, tgrads, jgrads, bwd=None):
    """Map torch param grads through the SAME (linear) import rules and
    compare against the jax param-grad pytree."""
    bwd = BWD if bwd is None else bwd
    tree = {"params": jax.tree.map(np.asarray, jgrads)}
    mapped = apply_import_rules(rules, tgrads, tree)
    for path, _ in rules.imports:
        want = np.asarray(wp._get_path(mapped, path))
        got = np.asarray(wp._get_path(tree, path))
        np.testing.assert_allclose(got, want, err_msg="/".join(path), **bwd)


# ---------------------------------------------------------------------------
# paper EfficientGraphConv (experiments/layers.py:11-147)
# ---------------------------------------------------------------------------

PAPER_CASES = [
    # (aggrs, weighting) — the reference's tuned sets + every gating variant
    (("symadd",), "softmax"),                # EGC-S (zinc/cifar/arxiv rows)
    (("add", "std", "max"), "none"),         # zinc EGC-M
    (("symadd", "max", "mean"), "none"),     # arxiv EGC-M
    (("symadd", "min", "max"), "none"),      # code2 EGC-M
    (("add", "mean", "max", "min", "symadd", "var", "std"), "none"),
    (("symadd", "std"), "sigmoid"),
    (("add", "max"), "hardtanh"),
]


@pytest.mark.parametrize("aggrs,weighting", PAPER_CASES)
def test_paper_egc_exec(ref_layers, rng, aggrs, weighting):
    n, in_c, out_c, H, B = 30, 20, 24, 4, 4
    s, r = rand_graph(rng, n)
    x = rng.normal(size=(n, in_c)).astype(np.float32)
    cot = rng.normal(size=(n, out_c)).astype(np.float32)

    torch.manual_seed(7)
    layer = ref_layers.EfficientGraphConv(
        in_c, out_c, H, B,
        softmax_weights=weighting == "softmax",
        sigmoid_weights=weighting == "sigmoid",
        hardtanh_weights=weighting == "hardtanh",
        aggrs=list(aggrs))
    xt = torch.tensor(x, requires_grad=True)
    ei = torch.tensor(np.stack([s, r]))
    out_t = layer(xt, ei)
    (out_t * torch.tensor(cot)).sum().backward()

    model = EGConv(out_channels=out_c, num_heads=H, num_bases=B,
                   aggrs=aggrs, weighting=weighting, self_loop_mode="paper")
    g = Graph.from_coo(jnp.asarray(x), s.astype(np.int32),
                       r.astype(np.int32))
    variables = model.init(jax.random.key(0), g, jnp.asarray(x))
    rules = wp._Rules()
    wp._egc_paper_rules(rules, ("params",), "", B)
    variables = apply_import_rules(rules, torch_sd(layer), variables)

    def loss(params, xj):
        out = model.apply({"params": params}, g, xj)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out_j),
                               out_t.detach().numpy(), **FWD)
    np.testing.assert_allclose(np.asarray(gx), xt.grad.numpy(), **BWD)
    check_param_grads(rules, torch_grads(layer), gp)


# ---------------------------------------------------------------------------
# optimized EGConv (experiments/optimized_layers.py:19-286)
# ---------------------------------------------------------------------------

OPT_CASES = [
    (("symnorm",), False),                   # EGC-S / mag h352 row
    (("sum", "mean", "max"), False),         # hiv EGC-M
    (("symnorm", "min", "var", "std"), False),
    (("mean", "max"), True),                 # sigmoid gating
]


@pytest.mark.parametrize("aggrs,sigmoid", OPT_CASES)
@pytest.mark.parametrize("sparse", [False, True])
def test_optimized_egconv_exec(ref_opt, rng, aggrs, sigmoid, sparse):
    n, in_c, out_c, H, B = 30, 20, 24, 4, 4
    s, r = rand_graph(rng, n, with_loops=False)
    x = rng.normal(size=(n, in_c)).astype(np.float32)
    cot = rng.normal(size=(n, out_c)).astype(np.float32)

    torch.manual_seed(11)
    layer = ref_opt.EGConv(in_c, out_c, aggrs=list(aggrs), num_heads=H,
                           num_bases=B, sigmoid=sigmoid)
    xt = torch.tensor(x, requires_grad=True)
    if sparse:
        # transposed-adjacency convention: row = dst, col = src
        adj = pyg_shim.SparseTensor(row=torch.tensor(r), col=torch.tensor(s),
                                    sparse_sizes=(n, n))
        out_t = layer(xt, adj)
    else:
        out_t = layer(xt, torch.tensor(np.stack([s, r])))
    (out_t * torch.tensor(cot)).sum().backward()

    model = EGConv(out_channels=out_c, num_heads=H, num_bases=B,
                   aggrs=aggrs, weighting="sigmoid" if sigmoid else "none",
                   self_loop_mode="all")
    g = Graph.from_coo(jnp.asarray(x), s.astype(np.int32),
                       r.astype(np.int32))
    variables = model.init(jax.random.key(0), g, jnp.asarray(x))
    rules = wp._Rules()
    wp._egc_optimized_rules(rules, ("params",), "", H, B, len(aggrs))
    variables = apply_import_rules(rules, torch_sd(layer), variables)

    def loss(params, xj):
        out = model.apply({"params": params}, g, xj)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out_j),
                               out_t.detach().numpy(), **FWD)
    np.testing.assert_allclose(np.asarray(gx), xt.grad.numpy(), **BWD)
    check_param_grads(rules, torch_grads(layer), gp)


def test_optimized_egconv_sparse_equals_dense(ref_opt, rng):
    """The reference's own two dispatch paths must agree under the shim —
    a self-consistency check on the shim itself."""
    n, in_c, out_c = 30, 20, 24
    s, r = rand_graph(rng, n, with_loops=False)
    x = rng.normal(size=(n, in_c)).astype(np.float32)
    torch.manual_seed(3)
    layer = ref_opt.EGConv(in_c, out_c, num_heads=4, num_bases=4,
                           aggrs=["symnorm", "mean", "max", "std"])
    out_dense = layer(torch.tensor(x), torch.tensor(np.stack([s, r])))
    adj = pyg_shim.SparseTensor(row=torch.tensor(r), col=torch.tensor(s),
                                sparse_sizes=(n, n))
    out_sparse = layer(torch.tensor(x), adj)
    np.testing.assert_allclose(out_sparse.detach().numpy(),
                               out_dense.detach().numpy(), **FWD)


# ---------------------------------------------------------------------------
# towered MPNN (experiments/layers.py:231-267)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggr", ["sum", "max"])
def test_mpnn_exec(ref_layers, rng, aggr):
    n, d = 30, 16
    s, r = rand_graph(rng, n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cot = rng.normal(size=(n, d)).astype(np.float32)

    torch.manual_seed(5)
    layer = ref_layers.Mpnn(aggr, d, d, towers=4)
    xt = torch.tensor(x, requires_grad=True)
    out_t = layer(xt, torch.tensor(np.stack([s, r])))
    (out_t * torch.tensor(cot)).sum().backward()

    model = MPNNConv(out_channels=d, aggr=aggr, towers=4)
    g = Graph.from_coo(jnp.asarray(x), s.astype(np.int32),
                       r.astype(np.int32))
    variables = model.init(jax.random.key(0), g, jnp.asarray(x))
    rules = wp._Rules()
    wp._conv_rules(rules, "mpnn-" + aggr, ("params",), "")
    variables = apply_import_rules(rules, torch_sd(layer), variables)

    def loss(params, xj):
        out = model.apply({"params": params}, g, xj)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out_j),
                               out_t.detach().numpy(), **FWD)
    np.testing.assert_allclose(np.asarray(gx), xt.grad.numpy(), **BWD)
    check_param_grads(rules, torch_grads(layer), gp)


# ---------------------------------------------------------------------------
# NET-level: the actual reference model classes (zinc/cifar/arxiv) execute
# under the shim (namespace-package import of experiments.*) and gate the
# full wiring — embedding, conv stack, BN placement, residual order,
# masked pooling, MLP heads — through the SAME weight_port model rules the
# checkpoint importer uses.
# ---------------------------------------------------------------------------

def batched_inputs(rng, n_graphs=3, feat_kind="zinc", hid=24):
    """Host graphs + torch batch + my padded batched Graph."""
    from egc_tpu.graph.structure import batch_np

    graphs, xs, eis, bvec, off = [], [], [], [], 0
    for gi in range(n_graphs):
        n = int(rng.integers(8, 14))
        s, r = rand_graph(rng, n, 3 * n, with_loops=False)
        if feat_kind == "zinc":
            # distinct atom types per graph: duplicate types give
            # IDENTICAL embedded rows, whose max-aggregation ties route
            # gradients differently per backend (see rand_graph docstring)
            x = rng.permutation(28)[:n].reshape(n, 1).astype(np.int64)
        else:
            x = rng.normal(size=(n, 5)).astype(np.float32)
        graphs.append(dict(nodes=x, senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
        xs.append(x)
        eis.append(np.stack([s, r]) + off)
        bvec.append(np.full(n, gi))
        off += n
    g, _ = batch_np(graphs, num_nodes=off + 8, num_edges=256,
                    num_graphs=n_graphs + 1)
    g = jax.tree.map(jnp.asarray, g)
    tb = pyg_shim.FakeBatch(
        torch.tensor(np.concatenate(xs)),
        torch.tensor(np.concatenate(eis, axis=1)),
        torch.tensor(np.concatenate(bvec)))
    return g, tb


def net_forward_check(ref_out, model, variables, g, n_valid, cot_shape,
                      rng, rules, tnet, bwd=None):
    bwd = BWD if bwd is None else bwd
    cot = rng.normal(size=ref_out.shape).astype(np.float32)
    (ref_out * torch.tensor(cot)).sum().backward()

    def loss(params):
        out = model.apply(
            {"params": params,
             "batch_stats": variables.get("batch_stats", {})},
            g, train=False)
        return jnp.sum(out[:n_valid] * jnp.asarray(cot)), out

    (_, out_j), gp = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    np.testing.assert_allclose(np.asarray(out_j)[:n_valid],
                               ref_out.detach().numpy(), **FWD)
    tgrads = {k: p.grad.detach().numpy()
              for k, p in tnet.named_parameters() if p.grad is not None}
    tree = {"params": jax.tree.map(np.asarray, gp)}
    for path, fn in rules.imports:
        if path[0] != "params":
            continue          # BN running stats carry no grads
        try:
            want = np.asarray(fn(tgrads))
        except (KeyError, wp.PortError):
            continue          # frozen leaves (BN stats) have no grads
        got = np.asarray(wp._get_path(tree, path))
        np.testing.assert_allclose(got, want, err_msg="/".join(path), **bwd)


@pytest.mark.parametrize("kind", ["egc", "gatv2"])
def test_zinc_net_exec(rng, kind):
    zinc_models = pyg_shim.import_reference_module("experiments.zinc.models")
    g, tb = batched_inputs(rng, feat_kind="zinc")
    hid, aggrs = 24, ("add", "std", "max")

    torch.manual_seed(23)
    spec = {}
    if kind == "egc":
        tnet = zinc_models.EgcZincNet(
            hidden_dim=hid, num_graph_layers=2, in_feat_drop=0.0,
            residual=True, heads=4, bases=4, aggrs=list(aggrs))
        spec = dict(heads=4, bases=4, aggrs=aggrs)
        conv_kw = dict(heads=4, bases=4, aggrs=aggrs)
    else:
        # Gatv2ZincNet: heads hard-coded to 8 (1 on the last layer) —
        # reference zinc/models.py:81-89
        tnet = zinc_models.Gatv2ZincNet(
            hidden_dim=hid, num_graph_layers=2, in_feat_drop=0.0,
            residual=True)
        conv_kw = dict(heads=8)
    tnet.eval()
    out_t = tnet(tb)

    from egc_tpu.models.nets import ConvSpec, ZincNet
    model = ZincNet(conv=ConvSpec(kind=kind, **conv_kw),
                    hidden_dim=hid, num_layers=2, residual=True)
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("zinc", kind, variables, **spec)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    net_forward_check(out_t, model, variables, g, 3, out_t.shape, rng,
                      rules, tnet)


@pytest.mark.parametrize("kind", ["egc", "gatv2"])
def test_cifar_net_exec(rng, kind):
    cifar_models = pyg_shim.import_reference_module(
        "experiments.cifar.models")
    g, tb = batched_inputs(rng, feat_kind="cifar")
    hid, aggrs = 24, ("symadd", "std", "max")

    torch.manual_seed(29)
    spec = {}
    if kind == "egc":
        tnet = cifar_models.EgcCifarNet(
            hidden_dim=hid, num_graph_layers=2, dropout=0.0,
            residual=True, heads=4, bases=4, aggrs=list(aggrs))
        spec = dict(heads=4, bases=4, aggrs=aggrs)
        conv_kw = dict(heads=4, bases=4, aggrs=aggrs)
    else:
        # Gatv2CifarNet: heads hard-coded to 8 (1 on the last layer) —
        # reference cifar/models.py:82-90
        tnet = cifar_models.Gatv2CifarNet(
            hidden_dim=hid, num_graph_layers=2, dropout=0.0,
            residual=True)
        conv_kw = dict(heads=8)
    tnet.eval()
    out_t = tnet(tb)

    from egc_tpu.models.nets import ConvSpec, CifarNet
    model = CifarNet(conv=ConvSpec(kind=kind, **conv_kw),
                     hidden_dim=hid, num_layers=2, residual=True)
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("cifar", kind, variables, **spec)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    net_forward_check(out_t, model, variables, g, 3, out_t.shape, rng,
                      rules, tnet)


@pytest.mark.parametrize("kind", ["egc", "mpnn-max", "gcn", "gat", "gatv2",
                                  "gin", "sage", "pna"])
def test_arxiv_net_exec(rng, kind):
    """The reference's six PyG-conv arxiv nets execute under the shim's
    PyG 2.0 conv zoo (pyg_shim.GCNConv..PNAConv) alongside the
    reference-authored EGC/MPNN layers — full-net fwd+bwd ground truth
    for every MODEL_KINDS entry (reference arxiv/norm_models.py:50-190)."""
    norm_models = pyg_shim.import_reference_module(
        "experiments.arxiv.norm_models")
    n, hid = 40, 24
    # gcn: plant an existing self-loop (gcn_norm's add_remaining dedup
    # path); self-loop-adding attention convs + loop-free-precondition
    # kinds use a loop-free graph (see rand_graph docstring)
    s, r = rand_graph(rng, n, 120, with_loops=(kind == "gcn"))
    x = rng.normal(size=(n, 128)).astype(np.float32)

    from egc_tpu.models.nets import ConvSpec
    torch.manual_seed(31)
    spec = {}
    net_kw = dict(hidden_dim=hid, num_graph_layers=2, dropout=0.0,
                  residual=True)
    if kind == "egc":
        aggrs = ("symadd", "max", "mean")
        tnet = norm_models.EgcArxivNet(
            heads=4, bases=4, softmax=False, aggrs=list(aggrs), **net_kw)
        spec = dict(heads=4, bases=4, aggrs=aggrs)
        conv = ConvSpec(kind="egc", heads=4, bases=4, aggrs=aggrs)
    elif kind == "mpnn-max":
        tnet = norm_models.MpnnArxivNet(aggr="max", **net_kw)
        conv = ConvSpec(kind="mpnn-max")
    elif kind == "gcn":
        tnet = norm_models.GcnArxivNet(**net_kw)
        conv = ConvSpec(kind="gcn")
    elif kind in ("gat", "gatv2"):
        tnet = norm_models.GatArxivNet(
            heads=4, gat_dropout=0.0,
            gat_version=1 if kind == "gat" else 2, **net_kw)
        conv = ConvSpec(kind=kind, heads=4)
    elif kind == "gin":
        tnet = norm_models.GinArxivNet(**net_kw)
        conv = ConvSpec(kind="gin")
    elif kind == "sage":
        tnet = norm_models.SageArxivNet(**net_kw)
        conv = ConvSpec(kind="sage")
    else:                                   # pna
        from egc_tpu.nn.conv.pna import avg_log_degree
        hist = np.bincount(np.bincount(r, minlength=n))
        tnet = norm_models.PnaArxivNet(deg=torch.tensor(hist), **net_kw)
        conv = ConvSpec(kind="pna", avg_log_deg=avg_log_degree(hist))
    tnet.eval()
    out_t = tnet(torch.tensor(x), torch.tensor(np.stack([s, r])))

    from egc_tpu.models.nets import ArxivNet
    model = ArxivNet(conv=conv, hidden_dim=hid, num_layers=2, dropout=0.0,
                     residual=True, num_features=128, num_classes=40)
    g = Graph.from_coo(jnp.asarray(x), s.astype(np.int32),
                       r.astype(np.int32))
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("arxiv", kind, variables, **spec)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    net_forward_check(out_t, model, variables, g, n, out_t.shape, rng,
                      rules, tnet)


def test_mag_net_exec(rng):
    """The reference's mag homogeneous EGC net (experiments/mag/models.py:
    16-70: optimized EGConv stack over a cached SparseTensor adjacency,
    relu+dropout between layers, no BN, 352->349 truncation, log_softmax)
    executes under the shim and gates MagNet fwd+bwd."""
    mag_models = pyg_shim.import_reference_module("experiments.mag.models")
    n, hid, aggrs = 40, 24, ("symnorm", "max", "mean")
    s, r = rand_graph(rng, n, 120, with_loops=False)
    x = rng.normal(size=(n, 128)).astype(np.float32)

    torch.manual_seed(43)
    tnet = mag_models.EGC(hidden_channels=hid, num_layers=3, dropout=0.0,
                          num_heads=4, num_bases=4, aggrs=list(aggrs))
    tnet.eval()
    adj = pyg_shim.SparseTensor(row=torch.tensor(r), col=torch.tensor(s),
                                sparse_sizes=(n, n))
    out_t = tnet(torch.tensor(x), adj)

    from egc_tpu.models.nets import MagNet
    model = MagNet(hidden_dim=hid, num_layers=3, dropout=0.0, heads=4,
                   bases=4, aggrs=aggrs)
    g = Graph.from_coo(jnp.asarray(x), s.astype(np.int32),
                       r.astype(np.int32))
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("mag", "egc", variables, heads=4, bases=4,
                           aggrs=aggrs)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    # 3 conv layers with no BN between (unlike every other family): grad
    # ranges reach ~4e3, so f32 reassociation leaves ~1e-3 ABSOLUTE noise
    # that crosses the default atol on near-zero elements; atol=2e-3
    # (5e-7 of the range) keeps a real layout bug unmistakable
    net_forward_check(out_t, model, variables, g, n, out_t.shape, rng,
                      rules, tnet, bwd=dict(rtol=5e-4, atol=2e-3))


# ---------------------------------------------------------------------------
# code2 pipeline: the reference's vocab/augment/encode/decode functions
# (experiments/code/utils.py, "borrowed from the OGB repo") execute and
# gate data/ondisk's numpy counterparts; EgcCodeNet gates CodeNet wiring
# (ASTNodeEncoder depth clamp, fused 5-head token predictor).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_code_utils():
    return pyg_shim.import_reference_module("experiments.code.utils")


def test_code2_vocab_encode_decode_exec(ref_code_utils, rng):
    from egc_tpu.data.ondisk import build_vocab, decode_arr, encode_seq

    words = [f"w{i}" for i in range(40)]
    seqs = [[words[rng.integers(0, 40)] for _ in range(rng.integers(1, 7))]
            for _ in range(60)]
    v2i_t, i2v_t = ref_code_utils.get_vocab_mapping(seqs, 25)
    v2i_j, i2v_j = build_vocab(seqs, 25)
    assert v2i_t == v2i_j and list(i2v_t) == list(i2v_j)

    for seq in seqs[:10]:
        enc_t = ref_code_utils.encode_seq_to_arr(seq, v2i_t, 5).numpy()[0]
        enc_j = encode_seq(seq, v2i_j, 5)
        np.testing.assert_array_equal(enc_j, enc_t, err_msg=str(seq))
        dec_t = ref_code_utils.decode_arr_to_seq(torch.tensor(enc_t), i2v_t)
        assert decode_arr(enc_j, i2v_j) == dec_t


def test_code2_augment_edge_exec(ref_code_utils, rng):
    from egc_tpu.data.ondisk import augment_ast_edges_np

    n = 25
    s, r = rand_graph(rng, n, 40, with_loops=False)
    is_att = rng.integers(0, 2, n)

    class Data:
        pass

    d = Data()
    d.edge_index = torch.tensor(np.stack([s, r]))
    d.node_is_attributed = torch.tensor(is_att.reshape(-1, 1))
    out = ref_code_utils.augment_edge(d)
    ei_t = out.edge_index.numpy()
    s_j, r_j = augment_ast_edges_np(s.astype(np.int32),
                                    r.astype(np.int32), is_att)
    # same concatenation order: ast, inverse-ast, next-token, inverse
    np.testing.assert_array_equal(s_j, ei_t[0])
    np.testing.assert_array_equal(r_j, ei_t[1])


@pytest.mark.parametrize("kind,aggrs", [
    ("egc", ("add", "mean", "max")),     # hiv EGC-M row
    ("mpnn-max", None),
    ("gcn", None), ("gat", None), ("gatv2", None), ("gin", None),
    ("sage", None),                      # mol/pna_style_models.py:86-215
])
def test_hiv_net_exec(rng, kind, aggrs):
    mol_models = pyg_shim.import_reference_module(
        "experiments.mol.pna_style_models")
    from egc_tpu.graph.structure import batch_np
    from egc_tpu.models.encoders import ATOM_FEATURE_DIMS

    hid = 24
    graphs, xs, eis, bvec, off = [], [], [], [], 0
    for gi in range(3):
        n = int(rng.integers(8, 14))
        s, r = rand_graph(rng, n, 3 * n, with_loops=False)
        # distinct feature ROWS per graph (ties, see rand_graph): make the
        # first (119-ary) feature distinct per node
        x = np.stack([rng.permutation(119)[:n]] +
                     [rng.integers(0, d, n)
                      for d in ATOM_FEATURE_DIMS[1:]], axis=1)
        graphs.append(dict(nodes=x.astype(np.int32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
        xs.append(x)
        eis.append(np.stack([s, r]) + off)
        bvec.append(np.full(n, gi))
        off += n
    g, _ = batch_np(graphs, num_nodes=off + 8, num_edges=256, num_graphs=4)
    g = jax.tree.map(jnp.asarray, g)

    torch.manual_seed(41)
    spec = {}
    conv_kw = {}
    net_kw = dict(hidden_dim=hid, num_graph_layers=2, in_feat_drop=0.0,
                  residual=True)
    if kind == "egc":
        tnet = mol_models.EgcHIVNet(heads=4, bases=4, aggrs=list(aggrs),
                                    **net_kw)
        spec = dict(heads=4, bases=4, aggrs=aggrs)
        conv_kw = dict(aggrs=aggrs, heads=4, bases=4)
    elif kind == "mpnn-max":
        tnet = mol_models.MpnnHIVNet(aggr="max", **net_kw)
    elif kind == "gcn":
        tnet = mol_models.GcnHIVNet(**net_kw)
    elif kind in ("gat", "gatv2"):
        tnet = mol_models.GatHIVNet(
            heads=4, gat_dropout=0.0,
            gat_version=1 if kind == "gat" else 2, **net_kw)
        conv_kw = dict(heads=4)
    elif kind == "gin":
        tnet = mol_models.GinHIVNet(**net_kw)
    else:
        tnet = mol_models.SageHIVNet(**net_kw)
    tnet.eval()
    tb = pyg_shim.FakeBatch(torch.tensor(np.concatenate(xs)),
                            torch.tensor(np.concatenate(eis, axis=1)),
                            torch.tensor(np.concatenate(bvec)))
    out_t = tnet(tb)

    from egc_tpu.models.nets import ConvSpec, HIVNet
    conv = ConvSpec(kind=kind, **conv_kw)
    model = HIVNet(conv=conv, hidden_dim=hid, num_layers=2, residual=True)
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("hiv", kind, variables, **spec)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    net_forward_check(out_t, model, variables, g, 3, out_t.shape, rng,
                      rules, tnet)


@pytest.mark.parametrize("kind", ["egc", "gat", "pna"])
def test_code_net_exec(rng, kind):
    code_models = pyg_shim.import_reference_module("experiments.code.models")
    from egc_tpu.graph.structure import batch_np

    hid, aggrs, vocab = 24, ("symadd", "min", "max"), 50
    graphs, xs, eis, depths, bvec, off = [], [], [], [], [], 0
    for gi in range(3):
        n = int(rng.integers(8, 14))
        s, r = rand_graph(rng, n, 3 * n, with_loops=False)
        t = rng.permutation(98)[:n]          # distinct types: avoid ties
        a = rng.permutation(200)[:n]
        dep = rng.integers(0, 25, n)         # exercises >max_depth clamp
        graphs.append(dict(
            nodes=np.stack([t, a, dep], 1).astype(np.int32),
            senders=s.astype(np.int32), receivers=r.astype(np.int32)))
        xs.append(np.stack([t, a], 1))
        depths.append(dep)
        eis.append(np.stack([s, r]) + off)
        bvec.append(np.full(n, gi))
        off += n
    g, _ = batch_np(graphs, num_nodes=off + 8, num_edges=256, num_graphs=4)
    g = jax.tree.map(jnp.asarray, g)

    torch.manual_seed(37)
    spec = {}
    conv_kw = {}
    net_kw = dict(hidden_dim=hid, num_graph_layers=2, in_feat_drop=0.0,
                  residual=True, vocab_size=vocab)
    if kind == "egc":
        tnet = code_models.EgcCodeNet(heads=4, bases=4, aggrs=list(aggrs),
                                      **net_kw)
        spec = dict(heads=4, bases=4, aggrs=aggrs)
        conv_kw = dict(heads=4, bases=4, aggrs=aggrs)
    elif kind == "gat":
        # GatCodeNet: tunable heads/dropout/version — code/models.py:137-184
        tnet = code_models.GatCodeNet(heads=4, gat_dropout=0.0,
                                      gat_version=1, **net_kw)
        conv_kw = dict(heads=4)
    else:
        # PnaCodeNet: PNAConv towers=4 divide_input — code/models.py:268-306
        degs = np.concatenate([
            np.bincount(gd["receivers"], minlength=len(gd["nodes"]))
            for gd in graphs])
        hist = np.bincount(degs)
        tnet = code_models.PnaCodeNet(deg=torch.tensor(hist), **net_kw)
        from egc_tpu.nn.conv.pna import avg_log_degree
        conv_kw = dict(avg_log_deg=avg_log_degree(hist))
    tnet.eval()
    tb = pyg_shim.FakeBatch(torch.tensor(np.concatenate(xs)),
                            torch.tensor(np.concatenate(eis, axis=1)),
                            torch.tensor(np.concatenate(bvec)))
    tb.node_depth = torch.tensor(np.concatenate(depths).reshape(-1, 1))
    out_t = torch.stack(tnet(tb), dim=1)      # [G, seq, vocab+2]

    from egc_tpu.models.nets import ConvSpec, CodeNet
    model = CodeNet(conv=ConvSpec(kind=kind, **conv_kw),
                    hidden_dim=hid, num_layers=2, residual=True,
                    vocab_size=vocab, num_nodeattributes=10030,
                    max_depth=20)
    variables = wp._unfreeze(model.init(jax.random.key(0), g, train=False))
    rules = wp.build_rules("code", kind, variables, **spec)
    variables = apply_import_rules(rules, torch_sd(tnet), variables)
    out_j = model.apply(variables, g, train=False)
    np.testing.assert_allclose(np.asarray(out_j)[:3],
                               out_t.detach().numpy(), **FWD)


# ---------------------------------------------------------------------------
# hetero RGCNConv / REGConv (experiments/rmag/models.py:30-148)
# ---------------------------------------------------------------------------

def hetero_fixture(ref_rmag, rng, in_c):
    """Tiny graph over the reference's FULL mag schema (its ModuleDicts are
    keyed by the global NODE_TYPES / EDGE_TYPES constants)."""
    counts = {"author": 9, "field_of_study": 7, "institution": 5,
              "paper": 11}
    x_np = {t: rng.normal(size=(c, in_c)).astype(np.float32)
            for t, c in counts.items()}
    edges_t = {}   # tuple key -> SparseTensor (row=dst, col=src)
    edges_j = {}   # our rel key -> (senders, receivers)
    for st, rel, dt in ref_rmag.EDGE_TYPES:
        e = 20
        src = rng.integers(0, counts[st], e).astype(np.int64)
        dst = rng.integers(0, counts[dt], e).astype(np.int64)
        # dedup: duplicate pairs tie in max (see rand_graph docstring)
        pair = np.unique(np.stack([src, dst], axis=1), axis=0)
        src, dst = pair[:, 0].copy(), pair[:, 1].copy()
        edges_t[(st, rel, dt)] = pyg_shim.SparseTensor(
            row=torch.tensor(dst), col=torch.tensor(src),
            sparse_sizes=(counts[dt], counts[st]))
        edges_j[rel_key(st, rel, dt)] = (src.astype(np.int32),
                                         dst.astype(np.int32))
    hg = hetero_from_numpy(x_np, edges_j)
    return counts, x_np, edges_t, hg


def hetero_compare(counts, out_t_dict, out_j_dict, tol):
    for t, c in counts.items():
        np.testing.assert_allclose(
            np.asarray(out_j_dict[t])[:c],
            out_t_dict[t].detach().numpy() if hasattr(out_t_dict[t], "detach")
            else out_t_dict[t],
            err_msg=t, **tol)


def test_rgcnconv_exec(ref_rmag, rng):
    in_c, out_c = 12, 8
    counts, x_np, edges_t, hg = hetero_fixture(ref_rmag, rng, in_c)
    cot = {t: rng.normal(size=(c, out_c)).astype(np.float32)
           for t, c in counts.items()}

    torch.manual_seed(13)
    layer = ref_rmag.RGCNConv(in_c, out_c)
    xt = {t: torch.tensor(v, requires_grad=True) for t, v in x_np.items()}
    out_t = layer(xt, edges_t)
    sum(
        (out_t[t] * torch.tensor(cot[t])).sum() for t in counts
    ).backward()

    model = RGCNConv(out_channels=out_c)
    x_dict = {t: jnp.asarray(v) for t, v in hg.nodes.items()}
    variables = model.init(jax.random.key(0), hg, x_dict)
    rules = wp._Rules()
    for t in counts:
        rules.linear(("params", f"root_{t}"), f"root_lins.{t}.")
    for st, rel, dt in ref_rmag.EDGE_TYPES:
        rules.linear(("params", f"rel_{rel_key(st, rel, dt)}"),
                     f"rel_lins.{st}_{rel}_{dt}.", bias=False)
    variables = apply_import_rules(rules, torch_sd(layer), variables)

    def loss(params, xd):
        out = model.apply({"params": params}, hg, xd)
        return sum(jnp.sum(out[t][:c] * jnp.asarray(cot[t]))
                   for t, c in counts.items()), out

    (_, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x_dict)
    hetero_compare(counts, out_t, out_j, FWD)
    for t, c in counts.items():
        np.testing.assert_allclose(np.asarray(gx[t])[:c],
                                   xt[t].grad.numpy(), err_msg=t, **BWD)
    check_param_grads(rules, torch_grads(layer), gp)


def test_regconv_exec(ref_rmag, rng):
    in_c, out_c, H, B = 12, 8, 4, 4
    counts, x_np, edges_t, hg = hetero_fixture(ref_rmag, rng, in_c)
    cot = {t: rng.normal(size=(c, out_c)).astype(np.float32)
           for t, c in counts.items()}

    torch.manual_seed(17)
    layer = ref_rmag.REGConv(in_c, out_c, H, B)
    xt = {t: torch.tensor(v, requires_grad=True) for t, v in x_np.items()}
    out_t = layer(xt, edges_t)
    sum(
        (out_t[t] * torch.tensor(cot[t])).sum() for t in counts
    ).backward()

    model = REGConv(out_channels=out_c, num_heads=H, num_bases=B)
    x_dict = {t: jnp.asarray(v) for t, v in hg.nodes.items()}
    variables = model.init(jax.random.key(0), hg, x_dict)
    rules = wp._Rules()
    rules.add(("params", "bases", "kernel"),
              lambda sd: np.asarray(sd["bases_weight"]),
              lambda v: {"bases_weight": np.asarray(v)},
              ["bases_weight"])
    for t in counts:
        rules.linear(("params", f"root_comb_{t}"), f"root_combs.{t}.")
    for st, rel, dt in ref_rmag.EDGE_TYPES:
        rules.linear(("params", f"rel_comb_{rel_key(st, rel, dt)}"),
                     f"rel_combs.{st}_{rel}_{dt}.")
    variables = apply_import_rules(rules, torch_sd(layer), variables)

    def loss(params, xd):
        out = model.apply({"params": params}, hg, xd)
        return sum(jnp.sum(out[t][:c] * jnp.asarray(cot[t]))
                   for t, c in counts.items()), out

    (_, out_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x_dict)
    hetero_compare(counts, out_t, out_j, FWD)
    for t, c in counts.items():
        np.testing.assert_allclose(np.asarray(gx[t])[:c],
                                   xt[t].grad.numpy(), err_msg=t, **BWD)
    check_param_grads(rules, torch_grads(layer), gp)


def test_regc_net_exec(ref_rmag, rng, monkeypatch):
    """NET-level rmag: the reference's full REGC wiring (rmag/models.py:
    151-212 — learned embeddings for the featureless node types, REGConv
    stack with relu+dropout between, final layer ALWAYS RGCNConv) executes
    under the shim and gates REGCNet fwd + every-param bwd through the
    same rmag import rules the checkpoint importer uses.

    Two import-time obstacles are patched WITHOUT touching the logic under
    test: (a) models.py:161 ``super(self).__init__()`` raises TypeError in
    every Python (SURVEY §7.3 quirk; this framework fixed — did not
    inherit — the bug, nn/conv/hetero.py): a module-level ``super`` shim
    maps the 1-arg call to ``super(type(obj), obj)``; (b) NUM_NODES_DICT
    carries full-mag node counts (~600 MB of embedding tables): shrunk to
    the fixture's counts. Neither changes the forward/backward semantics
    being gated."""
    from egc_tpu.nn.conv.hetero import REGCNet

    hid = 16
    counts, x_np, edges_t, hg = hetero_fixture(ref_rmag, rng, 128)
    featless = tuple(sorted(set(counts) - {"paper"}))

    def super_shim(*args):
        if len(args) == 1 and not isinstance(args[0], type):
            return super(type(args[0]), args[0])
        return super(*args)

    monkeypatch.setattr(ref_rmag, "super", super_shim, raising=False)
    monkeypatch.setattr(ref_rmag, "NUM_NODES_DICT", dict(counts))

    torch.manual_seed(47)
    tnet = ref_rmag.REGC(hidden_channels=hid, num_layers=3, dropout=0.0,
                         use_egc=True, egc_heads=4, egc_bases=4)
    tnet.eval()
    xt = {"paper": torch.tensor(x_np["paper"], requires_grad=True)}
    out_t = tnet(xt, edges_t)["paper"]
    logp_t = torch.log_softmax(out_t, dim=-1)
    cot = rng.normal(size=tuple(logp_t.shape)).astype(np.float32)
    (logp_t * torch.tensor(cot)).sum().backward()

    relations = tuple(rel_key(st, rel, dt)
                      for st, rel, dt in ref_rmag.EDGE_TYPES)
    model = REGCNet(hidden_dim=hid, num_layers=3, dropout=0.0,
                    use_egc=True, heads=4, bases=4, num_classes=349,
                    in_features=128, featureless_types=featless,
                    target_type="paper")
    variables = wp._unfreeze(model.init(jax.random.key(0), hg, train=False))
    rules = wp.build_rules("rmag", "regc", variables, heads=4, bases=4,
                           relations=relations,
                           node_types=tuple(sorted(counts)),
                           featureless_types=featless)

    def pad_embs(sd):
        # single-device REGCNet sizes its emb params to the PADDED type
        # counts (hg.num_nodes); pad rows touch only masked edges, so the
        # torch rows extend with zeros (and carry zero grads — asserted by
        # check_param_grads seeing the jax pad-row grads equal them)
        out = dict(sd)
        for t in featless:
            k = f"embs.{t}"
            v = np.asarray(out[k])
            out[k] = np.pad(v, ((0, hg.num_nodes(t) - v.shape[0]), (0, 0)))
        return out

    variables = apply_import_rules(rules, pad_embs(torch_sd(tnet)),
                                   variables)
    n_paper = counts["paper"]

    def loss(params):
        out = model.apply({"params": params}, hg, train=False)
        return jnp.sum(out[:n_paper] * jnp.asarray(cot)), out

    (_, out_j), gp = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    np.testing.assert_allclose(np.asarray(out_j)[:n_paper],
                               logp_t.detach().numpy(), **FWD)
    # final-layer heads for non-paper dst types are computed but unused
    # (only the paper rows feed the loss): torch reports grad None, jax
    # computes exact zeros — same statement
    tg = {k: (p.grad.detach().numpy() if p.grad is not None
              else np.zeros(tuple(p.shape), np.float32))
          for k, p in tnet.named_parameters()}
    # grad ranges reach ~1e2 through the un-BN'd 3-layer stack (same f32
    # reassociation accounting as test_mag_net_exec): absolute-scaled atol
    check_param_grads(rules, pad_embs(tg), gp,
                      bwd=dict(rtol=5e-4, atol=1e-4))
