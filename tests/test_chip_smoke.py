"""chip_smoke.py's phases, small, on the CPU — and, marked ``gpu``, at
their real sizes (skipped here; chip_smoke.py runs them on the card)."""

import jax
import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def small_graph():
    raw = cs.arxiv_graph(num_nodes=1200, avg_degree=8)
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict
    return raw, full_graph_to_device_dict(raw)


def test_phase_device_reports_platform(capsys):
    fields = cs.phase_device()
    assert fields["platform"] == "cpu"
    assert fields["device_count"] == jax.device_count()
    out = capsys.readouterr().out
    assert "nvidia-smi name, power.limit" in out and "compile cache" in out


def test_phase_trainer_small(small_graph, capsys):
    raw, _ = small_graph
    out = cs.phase_trainer(raw, iterations=2, hidden=32, heads=4, bases=2)
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert out["compile_s"] > 0 and np.isfinite(out["loss"])
    text = capsys.readouterr().out
    assert "memory_analysis: arguments" in text
    assert "iteration 1: train_loss" in text


def test_phase_cli_small(tmp_path, capsys):
    cs.phase_cli(tmp_path, check_epochs=1, hidden=16)
    assert "test_acc" in capsys.readouterr().out


def test_phase_attention_small(small_graph):
    _, data = small_graph
    out = cs.phase_attention(data, rows=(("gat", 16, 4), ("gatv2", 16, 4)))
    assert set(out) == {"gat", "gatv2"}
    assert all(np.isfinite(v["loss"]) for v in out.values())


def test_phase_reference_small(small_graph):
    _, data = small_graph
    out = cs.phase_reference(data, hidden=24, samples=300)
    assert out["highest_rel_l2"] <= 1e-5
    # the CPU backend multiplies float32 in float32 at either precision
    assert out["tf32_rel_l2"] < 1e-6


def test_reference_aggregate_detects_an_error(small_graph):
    """The host reference is sensitive: a wrong symnorm self weight fails."""
    _, data = small_graph
    s, r, w, sw = cs._host_graph(data["graph"])
    x = np.random.default_rng(0).uniform(-1, 1, (data["graph"].num_nodes, 8))
    rows = np.arange(50)
    good = cs.reference_aggregate(x, s, r, w, sw, rows, ("symnorm",))
    bad = cs.reference_aggregate(x, s, r, w, 0.5 * sw, rows, ("symnorm",))
    assert np.abs(good - bad).max() > 1e-3


def test_phase_partitioned_on_four_cpu_devices():
    raw = cs.arxiv_graph(num_nodes=600, avg_degree=6, seed=1)
    out = cs.phase_partitioned(raw, jax.devices()[:4], hidden=16)
    assert out["forward_rel_l2"] <= 1e-4 and out["params_rel_l2"] <= 1e-4


def test_phase_data_parallel_on_four_cpu_devices():
    out = cs.phase_data_parallel(jax.devices()[:4], graphs_per_device=3,
                                 hidden=16)
    assert out["loss_rel_err"] <= 1e-4 and out["params_rel_l2"] <= 1e-4


@pytest.mark.gpu
def test_reference_at_arxiv_width_on_card(gpu):
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict

    cs.phase_reference(full_graph_to_device_dict(cs.arxiv_graph()))


@pytest.mark.gpu
def test_attention_fits_at_arxiv_scale_on_card(gpu):
    from egc_tpu.exp.fullgraph import full_graph_to_device_dict

    cs.phase_attention(full_graph_to_device_dict(cs.arxiv_graph()))
