"""The harness on the CPU at a tiny size: a sound run is correct, the
control and each fault the cells can have are not, and a new
configuration, traffic mix and metric run from their files alone."""
import json

import pytest
import torch

import _ccbench_tiny as tiny
from repro_torch import api

CELLS = ["usa-road.solve", "kron-logn21.solve", "usa-road.churn",
         "kron-logn21.churn"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("ccbench"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(root, cell, trace):
    res = tiny.run(root, cell, trace=trace)
    assert res["correct"] is True
    assert res["checks"]["label_mismatches"] == {"value": 0, "limit": 0}
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    from ccbench.harness import cell_metrics
    want = {m["name"] for m in cell_metrics(bench, cell, trace)}
    # the device readers find nothing to read on the CPU
    cpu_silent = {m for m in want if m.startswith(("device_idle_share",
                                                   "cc_roofline_share"))}
    assert set(res["metrics"]) == want - cpu_silent
    assert "setup_s" in res["metrics"] or trace
    if trace:
        assert "breakdown" in res and "busy_s" in res["device"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    res = tiny.run(root, cell, control="truncated")
    assert res["correct"] is False
    assert res["checks"]["label_mismatches"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(root, cell, kind, monkeypatch):
    if cell.endswith(".solve"):
        monkeypatch.setattr(api, "solve", tiny.solve_fault(kind))
    else:
        tiny.churn_fault(monkeypatch, kind)
    res = tiny.run(root, cell)
    assert res["correct"] is False
    assert res["checks"]["label_mismatches"]["value"] > 0


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    root = tiny.tiny_tree(tmp_path)
    bench_dir = root / "ccbench"
    (bench_dir / "configs" / "grid-small.json").write_text(json.dumps({
        "name": "grid-small", "generator": "grid_road",
        "params": {"side": 24, "drop_prob": 0.2, "extra_prob": 0.05}}))
    (bench_dir / "traffic" / "solve-pair.json").write_text(json.dumps({
        "driver": "solve", "instances": 2, "sample": 1,
        "traced_iterations": 1}))
    (bench_dir / "metrics" / "solves_done.solve.py").write_text(
        "def read(ctx):\n    return ctx['counters']['solves']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "grid-small", "source": "test",
                             "file": "ccbench/configs/grid-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid-small.solve-pair",
                               "config": "grid-small",
                               "traffic": "solve-pair", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("grid-small.solve-pair")
    bench["per_layer"].append({
        "name": "solves_done.solve", "unit": "solves", "better": "higher",
        "source": "program_counter", "layer": "CC engine",
        "moves": "solve_edges_per_s", "workloads": ["grid-small.solve-pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = tiny.run(root, "grid-small.solve-pair")
    traced = tiny.run(root, "grid-small.solve-pair", trace=True)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"solve_edges_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"solves_done.solve"}
    assert traced["metrics"]["solves_done.solve"]["value"] >= 1
