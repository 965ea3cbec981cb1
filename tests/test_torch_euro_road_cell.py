"""The benchmark's ``euro-road`` configuration through the port's front
door on the CPU, its grid cut to sides 48 and 64: labels against the
benchmark's plain reference, the int64 work counters against the hook
rounds and sweeps that the ``cc.scan`` / ``cc.cleanup`` spans count, and
the configuration's ``generated`` counts against the generator's
exact-count formula at the published side."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch import api
from repro_torch.obs import trace as obs

BENCH = Path(__file__).resolve().parents[1] / "ccbench"
CONFIG = json.loads((BENCH / "configs" / "euro-road.json").read_text())


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "euro_cell_" + Path(rel).stem, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


grid_road = _load("generators/grid_road.py")
reference = _load("reference.py")


def _counts(side: int, drop_prob: float, extra_prob: float) -> tuple:
    """(|V|, |E|) of ``grid_road`` at ``side``, from its exact counts:
    the kept share of the 2 * side * (side - 1) grid edges, rounded,
    and ``extra_prob * side**2`` diagonals, at most (side - 1)**2."""
    n = side * side
    keep = round((1.0 - drop_prob) * 2 * side * (side - 1))
    return n, keep + min(int(extra_prob * n), (side - 1) ** 2)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.tracer().reset()
    yield
    obs.disable()
    obs.tracer().reset()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**33 + 1])
@pytest.mark.parametrize("side", [48, 64])
def test_euro_road_solve_matches_reference_and_counts(side, seed,
                                                      one_thread):
    params = dict(CONFIG["params"], side=side)
    gen = torch.Generator().manual_seed(seed)
    edges, n = grid_road.generate(params, gen, torch.device("cpu"))
    assert (n, edges.shape[0]) == _counts(side, params["drop_prob"],
                                          params["extra_prob"])
    obs.enable()
    res = api.solve(edges, n, device="cpu")
    obs.disable()
    want, _ = reference.cc_labels(edges, n)
    assert torch.equal(res.labels, want)
    assert all(v.dtype == torch.int64 for v in res.work)
    work = res.work.as_ints()
    spans = {e["name"]: e.get("tags", {})
             for e in obs.tracer().log.events()}
    scan, cleanup = spans["cc.scan"], spans["cc.cleanup"]
    assert work["hook_ops"] == 3 * edges.shape[0] * (1 + cleanup["rounds"])
    assert scan["sweeps"] + cleanup["sweeps"] == work["jump_sweeps"]
    assert scan["segments"] + cleanup["rounds"] == work["hook_rounds"]
    assert work["jump_ops"] == n * work["jump_sweeps"]


def test_generated_counts_follow_the_published_side():
    p, g = CONFIG["params"], CONFIG["generated"]
    n, e = _counts(p["side"], p["drop_prob"], p["extra_prob"])
    assert p["side"] == int(CONFIG["published"]["num_nodes"] ** 0.5)
    assert (g["num_nodes"], g["num_edges"]) == (n, e) \
        == (173_976_100, 229_631_305)
    assert g["edge_bytes"] == 8 * e
    assert g["avg_degree"] == round(2 * e / n, 4)
    # the counters this graph needs pass int32: |V| a sweep wraps after
    # 13 sweeps, and 3 hook_ops an edge over a scan and 3 cleanup rounds
    assert 13 * n > 2**31 - 1 and 12 * e > 2**31 - 1
