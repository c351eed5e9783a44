"""2-process ``jax.distributed`` smoke test — a multi-host rehearsal on CPU.

Makes docs/SCALING.md's multi-host recipe executable on one machine: two
OS processes each own 4 virtual CPU devices, ``jax.distributed.initialize``
wires them into one 8-device runtime, and a global mesh runs
(a) a psum sanity collective, (b) ONE data-parallel batched train step
with globally-sharded inputs (``jax.make_array_from_single_device_arrays``
from per-process microbatches — the exact multi-host pattern for the DP
path, egc_tpu.parallel.dp), and (c) ONE graph-partitioned full-graph train
step (halo ``all_to_all`` + sync-BN + grad psums over the ``graph`` axis,
egc_tpu.parallel.halo) — the flagship distributed path crossing a real
process boundary.

Usage:  python scripts/multihost_smoke.py              # launcher (spawns 2)
        python scripts/multihost_smoke.py --worker I   # internal
        python scripts/multihost_smoke.py --reference  # single-process
            8-device run of the SAME step (no jax.distributed) — the
            numeric reference the 2-process run must reproduce.

Prints one JSON line: {"ok": true, "loss": ..., "ploss": ..., "psum": 8.0}.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PORT = int(os.environ.get("EGC_SMOKE_PORT", "43219"))
NPROC = 2
LOCAL_DEVICES = 4


def worker(pid: int, nproc: int = NPROC, local_devices: int = LOCAL_DEVICES,
           distributed: bool = True):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{local_devices}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if distributed:
        jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                                   num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

    assert jax.device_count() == nproc * local_devices, jax.device_count()
    assert jax.process_count() == nproc
    devices = np.array(jax.devices()).reshape(nproc * local_devices)
    mesh = Mesh(devices, ("data",))

    from jax import shard_map as sm

    # (a) collective sanity: psum of ones over the global mesh
    def ones_psum(x):
        return jax.lax.psum(x, "data")

    sharding = NamedSharding(mesh, P("data"))
    local = [jax.device_put(jnp.ones((1,)), d) for d in jax.local_devices()]
    xs = jax.make_array_from_single_device_arrays(
        (nproc * local_devices,), sharding, local)
    total = jax.jit(sm(ones_psum, mesh=mesh, in_specs=P("data"),
                       out_specs=P("data")))(xs)
    psum_val = float(np.asarray(
        jax.experimental.multihost_utils.process_allgather(
            total, tiled=True))[0])

    # (b) one DP batched train step with globally-sharded microbatches
    from egc_tpu.data import synthetic
    from egc_tpu.graph.structure import batch_np
    from egc_tpu.models.nets import ConvSpec, ZincNet
    from egc_tpu.parallel import make_mesh, make_dp_train_step, \
        stack_microbatches
    from egc_tpu.train.optim import make_optimizer
    from egc_tpu.train.state import TrainState

    n_dev = nproc * local_devices
    splits = synthetic.synthetic_zinc(num_graphs=4 * n_dev)
    graphs = splits["train"][:2 * n_dev]
    micro = [batch_np(graphs[2 * d:2 * d + 2], num_nodes=80, num_edges=256,
                      num_graphs=3) for d in range(n_dev)]
    sg, sy = stack_microbatches(micro)   # leaves [n_dev, ...]

    def to_global(x):
        x = np.asarray(x)
        shard_spec = NamedSharding(mesh, P("data"))
        locs = []
        for k, d in enumerate(jax.local_devices()):
            g = pid * local_devices + k
            locs.append(jax.device_put(jnp.asarray(x[g:g + 1]), d))
        return jax.make_array_from_single_device_arrays(
            x.shape, shard_spec, locs)

    sg = jax.tree.map(to_global, sg)
    sy = to_global(np.asarray(sy))

    conv = ConvSpec(kind="egc", heads=2, bases=2, aggrs=("symnorm",),
                    softmax=True)
    net = ZincNet(conv=conv, hidden_dim=16, num_layers=2, residual=True,
                  bn_axis="data")
    g0 = jax.tree.map(jnp.asarray, micro[0][0])
    variables = net.init(jax.random.key(1), g0, train=False)
    state = TrainState.create(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=make_optimizer(1e-3, 1e-4))
    dmesh = make_mesh({"data": n_dev})

    def loss_sum(out, y, graph):
        err = jnp.abs(out.reshape(-1) - y.reshape(-1).astype(out.dtype))
        m = graph.graph_mask.astype(out.dtype)
        return jnp.sum(err * m), jnp.sum(m)

    step = make_dp_train_step(net, loss_sum, dmesh)
    state, loss = step(state, sg, sy, jax.random.key(0))
    loss = float(np.asarray(
        jax.experimental.multihost_utils.process_allgather(
            loss.reshape(1), tiled=True)).reshape(-1)[0])

    # (c) one GRAPH-PARTITIONED train step — the flagship distributed
    # path: halo all_to_all + sync-BN psums + grad psums cross PROCESS
    # boundaries (Gloo) here, not just the single-process virtual mesh
    # (VERDICT r4 item 7). Same seeds as --reference, which must match.
    from egc_tpu.graph.structure import Graph
    from egc_tpu.graph.transforms import symnorm_weight
    from egc_tpu.models.nets import ArxivNet
    from egc_tpu.parallel import (
        partition_graph, DistributedNodeClassifier,
        make_partitioned_train_step,
    )

    raw = synthetic.synthetic_full_graph(
        num_nodes=240, avg_degree=6, num_classes=4, num_features=8, seed=7)
    n = raw["x"].shape[0]
    conv_p = ConvSpec(kind="egc", heads=2, bases=2,
                      aggrs=("symnorm", "max"))
    ref_net = ArxivNet(conv=conv_p, hidden_dim=16, num_layers=2,
                       dropout=0.0, residual=True, num_features=8,
                       num_classes=4)
    g0p = jax.tree.map(jnp.asarray, Graph.from_coo(
        raw["x"], raw["senders"], raw["receivers"]))
    pvars = ref_net.init(jax.random.key(1), g0p, train=False)

    ew, sw = symnorm_weight(jnp.asarray(raw["senders"]),
                            jnp.asarray(raw["receivers"]), n)
    plan = partition_graph(raw["senders"], raw["receivers"], n, n_dev,
                           method="bfs", sym_edge_w=np.asarray(ew),
                           sym_self_w=np.asarray(sw))
    x_ext = np.zeros((n_dev, plan.n_ext, 8), np.float32)
    x_ext[:, :plan.n_local] = plan.scatter_nodes(raw["x"])
    gl = plan.extended_graph(x_ext)
    tmask = np.zeros(n, bool)
    tmask[raw["train_idx"]] = True

    gmesh = Mesh(devices, ("graph",))

    def to_global_p(x):
        x = np.asarray(x)
        locs = []
        for k, d in enumerate(jax.local_devices()):
            gdev = pid * local_devices + k
            locs.append(jax.device_put(jnp.asarray(x[gdev:gdev + 1]), d))
        return jax.make_array_from_single_device_arrays(
            x.shape, NamedSharding(gmesh, P("graph")), locs)

    dnet = DistributedNodeClassifier(conv=conv_p, hidden_dim=16,
                                     num_layers=2, dropout=0.0,
                                     residual=True, num_features=8,
                                     num_classes=4,
                                     e_interior=plan.e_interior)
    pstate = TrainState.create(params=pvars["params"],
                               batch_stats=pvars["batch_stats"],
                               tx=make_optimizer(1e-3, 0.0))
    pstep = make_partitioned_train_step(dnet, gmesh)
    gl_g = jax.tree.map(to_global_p, gl)
    sidx_g = to_global_p(plan.send_idx)
    y_g = to_global_p(plan.scatter_nodes(raw["y"]))
    m_g = to_global_p(plan.scatter_nodes(tmask))
    _, ploss = pstep(pstate, gl_g, sidx_g, y_g, m_g, jax.random.key(0))
    ploss = float(np.asarray(
        jax.experimental.multihost_utils.process_allgather(
            ploss.reshape(1), tiled=True)).reshape(-1)[0])

    if pid == 0:
        print(json.dumps({"ok": bool(np.isfinite(loss)
                                     and np.isfinite(ploss)
                                     and psum_val == n_dev),
                          "loss": loss, "ploss": ploss,
                          "psum": psum_val}), flush=True)
    if distributed:
        jax.distributed.shutdown()


def launcher():
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for pid in range(NPROC):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid)], env=env,
            stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL))
    rc = [p.wait(timeout=600) for p in procs]
    sys.exit(max(rc))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
    elif len(sys.argv) > 1 and sys.argv[1] == "--reference":
        # same step, one process owning all 8 virtual devices — the
        # numeric reference the cross-process run must reproduce
        worker(0, nproc=1, local_devices=NPROC * LOCAL_DEVICES,
               distributed=False)
    else:
        launcher()
