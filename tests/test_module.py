"""The module layer (egc_tpu/nn/module.py).

Gates:
- every net kind's parameter and batch-stats tree (key paths and shapes)
  equals ``golden_param_trees.json``, recorded from the flax build the
  layer replaced (checkpoints and the torch weight port depend on them);
- ``mutable=["batch_stats"]`` returns updated statistics and leaves the
  input untouched; without it the statistics cannot change;
- dropout draws from the ``dropout`` key: same key same mask, and no key
  means no dropout only when deterministic;
- ``remat`` gives the same values and gradients as the plain call.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from egc_tpu.data import synthetic
from egc_tpu.graph.hetero import hetero_from_numpy
from egc_tpu.graph.structure import Graph, batch_np
from egc_tpu.graph.transforms import symnorm_weight
from egc_tpu.models.nets import (
    ArxivNet, CifarNet, CodeNet, ConvSpec, HIVNet, MagNet, ZincNet,
)
from egc_tpu.nn import (
    EGConv, GATConv, GATv2Conv, GCNConv, GINConv, MLP, MPNNConv, PNAConv,
    SAGEConv, MaskedBatchNorm,
)
from egc_tpu.nn.conv.hetero import REGCNet, REGConv, RGCNConv
from egc_tpu.nn.module import Dense, Dropout, Module
from egc_tpu.parallel import (
    DistributedNodeClassifier, init_partitioned, make_mesh, partition_graph,
)

def collection_paths(tree):
    """``{"a/b/c": shape}`` for every leaf of a nested variable dict."""
    return {"/".join(str(p.key) for p in path): tuple(np.shape(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


GOLDEN = json.loads(
    (Path(__file__).parent / "golden_param_trees.json").read_text())

CONVS = {
    "egc": ConvSpec(kind="egc", heads=2, bases=2,
                    aggrs=("symnorm", "max", "mean")),
    "gcn": ConvSpec(kind="gcn"), "gat": ConvSpec(kind="gat", heads=2),
    "gatv2": ConvSpec(kind="gatv2", heads=2), "gin": ConvSpec(kind="gin"),
    "mpnn-sum": ConvSpec(kind="mpnn-sum"),
    "mpnn-max": ConvSpec(kind="mpnn-max"),
    "pna": ConvSpec(kind="pna", avg_log_deg=1.5),
    "sage": ConvSpec(kind="sage"),
}


def _full():
    raw = synthetic.synthetic_full_graph(num_nodes=64, avg_degree=4,
                                         num_classes=5, num_features=8,
                                         seed=0)
    g = jax.tree.map(jnp.asarray, Graph.from_coo(
        raw["x"], raw["senders"], raw["receivers"]))
    return raw, g


def _batch(splits):
    g, _ = batch_np(splits["train"][:3], num_nodes=1024, num_edges=8192,
                    num_graphs=4)
    return jax.tree.map(jnp.asarray, g)


def _rmag():
    raw = synthetic.synthetic_rmag(num_paper=60, num_author=30, num_inst=5,
                                   num_fos=8, num_classes=5, num_features=8,
                                   seed=0)
    hg = jax.tree.map(jnp.asarray, hetero_from_numpy(raw["nodes"],
                                                     raw["edges"]))
    featless = tuple(sorted(t for t, x in raw["nodes"].items()
                            if x.shape[-1] == 0))
    return hg, featless


def _variables(case):
    """``init`` variables of the net named ``case`` (a golden key)."""
    key = jax.random.key(0)
    family, name = case.split("/")
    if family == "arxiv":
        _, g = _full()
        kind = name.replace("-remat", "")
        net = ArxivNet(conv=CONVS[kind], hidden_dim=16, num_layers=3,
                       num_features=8, num_classes=5,
                       remat=name.endswith("-remat"))
        return net.init(key, g, train=False)
    if family == "mag":
        _, g = _full()
        net = MagNet(hidden_dim=16, num_layers=2, heads=2, bases=2,
                     out_rounded=8, out_true=5, remat=name.endswith("-remat"))
        return net.init(key, g, train=False)
    if family in ("zinc", "cifar", "hiv", "code"):
        gen = {"zinc": synthetic.synthetic_zinc,
               "cifar": synthetic.synthetic_cifar,
               "hiv": synthetic.synthetic_molhiv,
               "code": synthetic.synthetic_code}[family]
        g = _batch(gen(num_graphs=20))
        conv = CONVS[name]
        if family == "zinc":
            net = ZincNet(conv=conv, hidden_dim=16, num_layers=2)
        elif family == "cifar":
            net = CifarNet(conv=conv, hidden_dim=16, num_layers=2)
        elif family == "hiv":
            net = HIVNet(conv=conv, hidden_dim=16, num_layers=2)
        else:
            net = CodeNet(conv=conv, hidden_dim=16, num_layers=2,
                          vocab_size=120, num_nodeattributes=500)
        return net.init(key, g, train=False)
    if family == "rmag":
        hg, featless = _rmag()
        net = REGCNet(hidden_dim=16, num_layers=2, use_egc=name == "regc",
                      heads=2, bases=2, num_classes=5, in_features=8,
                      featureless_types=featless)
        return net.init(key, hg, train=False)
    if family == "partitioned":
        raw, _ = _full()
        n = raw["x"].shape[0]
        ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                                jnp.asarray(raw["receivers"]), n)
        plan = partition_graph(raw["senders"], raw["receivers"], n, 2,
                               method="bfs", sym_edge_w=np.asarray(ew),
                               sym_self_w=np.asarray(sw))
        x_ext = np.zeros((2, plan.n_ext, 8), np.float32)
        x_ext[:, :plan.n_local] = plan.scatter_nodes(raw["x"])
        gl = jax.tree.map(jnp.asarray, plan.extended_graph(x_ext))
        dnet = DistributedNodeClassifier(
            conv=CONVS[name], hidden_dim=16, num_layers=3, num_features=8,
            num_classes=5, e_interior=plan.e_interior)
        return init_partitioned(dnet, make_mesh({"graph": 2}), gl,
                                jnp.asarray(plan.send_idx), key)
    assert family == "conv", case
    _, g = _full()
    x16 = jnp.ones((g.num_nodes, 16))
    if name in ("regc", "rgcn"):
        hg, _ = _rmag()
        xd = {t: (hg.nodes[t] if hg.nodes[t].shape[-1]
                  else jnp.ones((hg.num_nodes(t), 8)))
              for t in hg.node_types}
        conv = (REGConv(16, num_heads=2, num_bases=2) if name == "regc"
                else RGCNConv(16))
        return conv.init(key, hg, xd)
    conv = {"egc": EGConv(16, num_heads=2, num_bases=2,
                          aggrs=("symnorm", "max")),
            "gcn": GCNConv(16), "gat": GATConv(4, heads=2),
            "gatv2": GATv2Conv(4, heads=2),
            "gin": GINConv(mlp=MLP([16, 16]), train_eps=True),
            "sage": SAGEConv(16), "mpnn": MPNNConv(16),
            "pna": PNAConv(16, avg_log_deg=1.2)}[name]
    return conv.init(key, g, x16)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_tree_paths_match_golden(case):
    variables = _variables(case)
    got = {coll: {k: list(v) for k, v in collection_paths(tree).items()}
           for coll, tree in variables.items()}
    assert got == GOLDEN[case]


def _bn_case():
    x = jnp.asarray(np.random.default_rng(0).normal(2.0, 3.0, (32, 4)),
                    jnp.float32)
    mask = jnp.arange(32) < 24
    bn = MaskedBatchNorm()
    return bn, x, mask, bn.init(jax.random.key(0), x, mask,
                                use_running_average=False)


def test_mutable_batch_stats_update_and_input_untouched():
    bn, x, mask, variables = _bn_case()
    before = jax.tree.map(np.asarray, variables["batch_stats"])
    _, mutated = bn.apply(variables, x, mask, use_running_average=False,
                          mutable=["batch_stats"])
    xv = np.asarray(x)[:24].astype(np.float64)
    np.testing.assert_allclose(np.asarray(mutated["batch_stats"]["mean"]),
                               0.1 * xv.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mutated["batch_stats"]["var"]),
                               0.9 + 0.1 * xv.var(0, ddof=1), rtol=1e-5)
    jax.tree.map(np.testing.assert_array_equal, before,
                 jax.tree.map(np.asarray, variables["batch_stats"]))


def test_batch_stats_immutable_without_mutable():
    bn, x, mask, variables = _bn_case()
    with pytest.raises(ValueError, match="not mutable"):
        bn.apply(variables, x, mask, use_running_average=False)
    # eval reads the running statistics and needs no mutation
    out = bn.apply(variables, x, mask, use_running_average=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) / np.sqrt(
        1.0 + 1e-5), rtol=1e-6)


class _Drop(Module):
    rate: float

    def __call__(self, x, *, train: bool):
        return Dropout(self.rate, deterministic=not train)(x)


def test_dropout_rngs():
    m = _Drop(0.5)
    x = jnp.ones((64, 32))
    v = m.init(jax.random.key(0), x, train=False)

    def run(seed):
        return np.asarray(m.apply(v, x, train=True,
                                  rngs={"dropout": jax.random.key(seed)}))

    a, b = run(1), run(2)
    np.testing.assert_array_equal(a, run(1))
    assert not np.array_equal(a, b)
    assert set(np.unique(a)) <= {0.0, 2.0}
    assert 0.35 < (a == 0).mean() < 0.65
    np.testing.assert_array_equal(np.asarray(m.apply(v, x, train=False)),
                                  np.asarray(x))
    with pytest.raises(ValueError, match="dropout"):
        m.apply(v, x, train=True)


@pytest.mark.parametrize("net_kind", ["arxiv", "mag"])
def test_remat_equals_no_remat(net_kind):
    raw, g = _full()
    y = jnp.asarray(raw["y"])

    def make(remat):
        if net_kind == "arxiv":
            return ArxivNet(conv=CONVS["egc"], hidden_dim=16, num_layers=3,
                            num_features=8, num_classes=5, dropout=0.3,
                            remat=remat)
        return MagNet(hidden_dim=16, num_layers=2, heads=2, bases=2,
                      out_rounded=8, out_true=5, dropout=0.3, remat=remat)

    plain, rem = make(False), make(True)
    variables = plain.init(jax.random.key(0), g, train=False)

    def loss(net, params):
        out, mut = net.apply({**variables, "params": params}, g, train=True,
                             rngs={"dropout": jax.random.key(3)},
                             mutable=["batch_stats"])
        nll = -jnp.take_along_axis(out, y[:, None], axis=1)
        return jnp.mean(nll), mut

    (l0, m0), g0 = jax.value_and_grad(
        lambda p: loss(plain, p), has_aux=True)(variables["params"])
    (l1, m1), g1 = jax.jit(jax.value_and_grad(
        lambda p: loss(rem, p), has_aux=True))(variables["params"])
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(jax.tree.leaves((g0, m0)), jax.tree.leaves((g1, m1))):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_shared_submodule_reuses_parameters():
    class Twice(Module):
        def __call__(self, a, b):
            d = Dense(3, name="shared")
            return d(a), d(b)

    m = Twice()
    a, b = jnp.ones((2, 4)), 2 * jnp.ones((2, 4))
    v = m.init(jax.random.key(0), a, b)
    assert collection_paths(v["params"]) == {"shared/kernel": (4, 3),
                                             "shared/bias": (3,)}
    oa, ob = m.apply(v, a, b)
    k, bias = v["params"]["shared"]["kernel"], v["params"]["shared"]["bias"]
    np.testing.assert_allclose(np.asarray(ob), np.asarray(2 * a @ k + bias),
                               rtol=1e-6)


def test_missing_parameter_and_duplicate_names_raise():
    class Clash(Module):
        def __call__(self, x):
            return Dense(2, name="d")(x) + Dense(2, name="d")(x)

    with pytest.raises(ValueError, match="two submodules named 'd'"):
        Clash().init(jax.random.key(0), jnp.ones((1, 2)))
    with pytest.raises(KeyError, match="kernel"):
        Dense(2).apply({"params": {}}, jnp.ones((1, 2)))
    with pytest.raises(RuntimeError, match="outside init/apply"):
        Dense(2)(jnp.ones((1, 2)))


def test_param_values_depend_on_seed_and_path_only():
    _, g = _full()
    net = ArxivNet(conv=CONVS["egc"], hidden_dim=16, num_layers=2,
                   num_features=8, num_classes=5)
    a = net.init(jax.random.key(0), g, train=False)["params"]
    b = net.init(jax.random.key(0), g, train=False)["params"]
    c = net.init(jax.random.key(1), g, train=False)["params"]
    jax.tree.map(np.testing.assert_array_equal, a, b)
    assert not np.array_equal(np.asarray(a["embed"]["kernel"]),
                              np.asarray(c["embed"]["kernel"]))
    # distinct paths draw distinct values
    assert not np.array_equal(np.asarray(a["EGConv_0"]["bases"]["kernel"]),
                              np.asarray(a["EGConv_1"]["bases"]["kernel"]))
