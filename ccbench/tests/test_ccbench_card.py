"""On the card, at each cell's own size: the control (the plain
reference cut one hooking round short, in the program's place) and each
fault planted in the program (a state left unchanged, half of each
batch left out) come out not correct. Marked ``cuda``; skips where
there is no card."""
import time

import pytest
import torch

import _ccbench_tiny as tiny
from ccbench import harness

CELLS = ["usa-road.solve", "kron-logn21.solve", "usa-road.churn",
         "kron-logn21.churn"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _run(card, cell, control=None):
    return harness.run_cell(tiny.ROOT, cell, tiny.SEED, 2.0, False, card,
                            time.perf_counter(), control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size_is_not_correct(card, cell):
    res = _run(card, cell, control="truncated")
    assert res["correct"] is False
    assert res["checks"]["label_mismatches"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_at_cell_size_is_not_correct(card, cell, kind, monkeypatch):
    from repro_torch import api
    if cell.endswith(".solve"):
        monkeypatch.setattr(api, "solve", tiny.solve_fault(kind))
    else:
        tiny.churn_fault(monkeypatch, kind)
    res = _run(card, cell)
    print(f"{cell} {kind}: {res['checks']}")
    assert res["correct"] is False
    assert res["checks"]["label_mismatches"]["value"] > 0
