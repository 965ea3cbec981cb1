"""Shared set-up of the benchmark's CPU tests: the import path, and a
copy of the benchmark's tree whose configurations are cut to a size the
CPU runs in a fraction of a second."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_PARAMS = {"grid_road": {"side": 40},
               "rmat": {"scale": 9, "edge_factor": 8, "num_edges": 2000}}
SEED = 2**31 + 11


def tiny_tree(dst: Path) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``ccbench/`` with every
    configuration cut to ``TINY_PARAMS`` and the churn batch to 32."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "ccbench", dst / "ccbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg["params"].update(TINY_PARAMS[cfg["generator"]])
        path.write_text(json.dumps(cfg))
    for mix in (dst / "ccbench" / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        if "batch" in t:
            t["batch"] = 32
        mix.write_text(json.dumps(t))
    return dst


def run(root: Path, workload: str, *, trace: bool = False,
        seconds: float = 0.3, control=None, seed: int = SEED) -> dict:
    from ccbench import harness
    return harness.run_cell(root, workload, seed, seconds, trace, "cpu",
                            time.perf_counter(), control=control)


def solve_fault(kind):
    """``api.solve`` with one fault the solve cells can have."""
    from repro_torch import api
    from repro_torch.core.cc import CCResult
    real = api.solve

    def faulty(edges, num_nodes, *a, **kw):
        if kind == "unchanged":        # the initial state, never hooked
            res = real(edges[:0], num_nodes, *a, **kw)
        elif kind == "half_batch":     # half of the edges left out
            res = real(edges[:edges.shape[0] // 2], num_nodes, *a, **kw)
        else:                          # one answer altered where made
            res = real(edges, num_nodes, *a, **kw)
            labels = res.labels.clone()
            labels[-1] = (labels[-1] + 1) % num_nodes
            res = CCResult(labels, res.work)
        return res
    return faulty


def churn_fault(monkeypatch, kind):
    """Plant one fault the churn cells can have in ``Solver``."""
    from repro_torch.api import DeviceGraph, Solver
    if kind == "unchanged":            # a delete that leaves the state
        monkeypatch.setattr(Solver, "delete",
                            lambda self, edges: self.version_device)
    elif kind == "half_batch":         # half of each insert left out
        real = Solver.insert

        def half(self, delta):
            t = delta.true_edges // 2
            return real(self, DeviceGraph.from_edges(delta.edges[:t],
                                                     delta.num_nodes))
        monkeypatch.setattr(Solver, "insert", half)
    else:                              # one answer altered where made
        real = Solver.labels

        def altered(self):
            labels = real.fget(self).clone()
            labels[-1] = (labels[-1] + 1) % self.num_nodes
            return labels
        monkeypatch.setattr(Solver, "labels", property(altered))
