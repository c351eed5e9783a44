"""utils (logging / debug / profiling) and CLI subprocess tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


def test_jsonl_logger(tmp_path):
    from egc_tpu.utils import JSONLLogger

    log = JSONLLogger(tmp_path / "m.jsonl")
    log.log({"step": 1, "loss": 0.5})
    log.log({"step": 2, "loss": 0.25})
    log.close()
    rows = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert rows[1]["loss"] == 0.25 and "ts" in rows[0]


def test_throughput_meter():
    import time
    from egc_tpu.utils import ThroughputMeter

    m = ThroughputMeter(edges_per_step=1000, warmup=1)
    for _ in range(3):
        m.step_start()
        time.sleep(0.01)
        m.step_end()
    s = m.summary()
    assert m.counted_steps == 2
    assert 10_000 < s["edges_per_s"] < 120_000


def test_check_finite():
    import jax.numpy as jnp
    from egc_tpu.utils import check_finite

    check_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError, match="a"):
        check_finite({"a": jnp.array([1.0, np.nan])})


def test_cli_subprocess(tmp_path):
    """Drive main.py through a real subprocess (arg parsing included)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = subprocess.run(
        [sys.executable, "main.py", str(tmp_path), "egc", "zinc",
         "--check", "--check-epochs", "1", "--hidden", "16",
         "--egc-num-heads", "2", "--egc-num-bases", "2",
         "--aggrs", "symadd"],
        capture_output=True, text=True, timeout=420, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert code.returncode == 0, code.stderr[-2000:]
    assert "test_loss" in code.stdout


def test_cli_rejects_unsupported_combo(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = subprocess.run(
        [sys.executable, "main.py", str(tmp_path), "pna", "zinc",
         "--check", "--hidden", "16"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert code.returncode != 0
    assert "not supported" in code.stderr + code.stdout


def test_parity_from_real_dryrun(tmp_path):
    """The one-command real-data parity runner works end to end on
    fabricated artifacts (VERDICT r4 item 9): fabricates an on-disk
    dataset + a reference-format checkpoint, restores through the
    --pretrained path, evaluates, and emits the diff table."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = subprocess.run(
        ["bash", "scripts/parity_from_real.sh", str(tmp_path / "root"),
         "--fabricate", "--rows", "arxiv:egc_m"],
        capture_output=True, text=True, timeout=560, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert code.returncode == 0, code.stdout[-1500:] + code.stderr[-1500:]
    rows = [json.loads(ln) for ln in code.stdout.splitlines()
            if ln.startswith("{")]
    summary = rows[-1]
    assert summary["evaluated"] == 1 and summary["failed"] == 0, rows
    assert rows[0]["status"] == "ok(pipeline)", rows


def test_bench_grid_smoke():
    """Every GRID row of bench.py runs end-to-end on tiny shapes (in-process
    on the CPU: bench.py itself refuses to measure without a GPU) and
    names the device it ran on."""
    import bench
    from egc_tpu.data import synthetic
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict

    d = full_graph_to_device_dict(synthetic.synthetic_full_graph(
        num_nodes=512, avg_degree=6, num_classes=40, num_features=128,
        seed=0))
    rows = bench.run_grid(d, steps=1, card="none, 0 W")
    assert len(rows) == 5
    assert {r["metric"] for r in rows} == {
        "egc_m_arxiv_train_edges_per_s_per_chip",
        "egc_s_arxiv_train_edges_per_s_per_chip",
        "egc_m6_arxiv_train_edges_per_s_per_chip",
        "egc_m_h136_arxiv_train_edges_per_s_per_chip",
        "gat_h152_arxiv_train_edges_per_s_per_chip"}
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in rows)
    assert all(r["platform"] == "cpu" and r["device_count"] >= 1
               and r["card"] == "none, 0 W" for r in rows)
    json.dumps(rows)
