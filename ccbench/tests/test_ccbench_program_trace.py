"""``program_trace.py`` on the CPU at a tiny size: the reduction that
keeps the program's ranges out of busy time and names them in the idle
gaps, and a run of each cell that reads the program's spans and read
counters over its window and is still correct."""
import types

import pytest

import _ccbench_tiny as tiny
from ccbench import profile, program_trace

CELLS = ["usa-road.solve", "kron-logn21.solve", "usa-road.churn",
         "kron-logn21.churn"]


def _event(name, start_us, end_us, device):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start_us,
                                                    end=end_us),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=False)


def test_reduce_leaves_program_ranges_out_and_names_them_in_gaps():
    events = [
        _event(profile.WINDOW, 0, 100, False),
        _event("ccbench.run", 0, 100, False),
        _event("cc.scan", 10, 90, False),
        _event("cudaStreamSynchronize", 40, 60, False),
        _event("kernel_a", 0, 30, True),
        # the device row the profiler makes of the program's range
        _event("cc.scan", 10, 90, True),
        _event("kernel_b", 70, 100, True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    out = program_trace.reduce(prof, {"cc.scan"})
    assert out["busy_s"] == pytest.approx(60e-6)
    assert {k for k, _ in out["device_ops"]} == {"kernel_a", "kernel_b"}
    assert out["idle_gaps"] == [["run:cc.scan:cudaStreamSynchronize",
                                 pytest.approx(40e-6)]]
    # the benchmark's own reduction counts the program's row as busy
    assert profile.reduce(prof)["busy_s"] == pytest.approx(100e-6)


def test_a_gap_outside_every_program_range_keeps_its_label():
    events = [_event(profile.WINDOW, 0, 100, False),
              _event("ccbench.delete", 0, 100, False),
              _event("aten::index", 40, 60, False),
              _event("kernel_a", 0, 30, True),
              _event("kernel_b", 70, 100, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    gaps = program_trace.reduce(prof, {"dyn.scoped"})["idle_gaps"]
    assert [k for k, _ in gaps] == ["delete:aten::index"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("ccbench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_reads_the_program_and_stays_correct(root, cell):
    from repro_torch.obs import trace as obs
    res = program_trace.run(root, cell, tiny.SEED, 0.3, "cpu")
    assert res["correct"] is True and not obs.enabled()
    prog, got = res["program"], res["derived"]
    assert prog["dropped"] == 0 and res["iterations"] > 0
    assert "read.sweep" in prog["counters"] or cell.endswith(".churn")
    if cell.endswith(".solve"):
        assert got["host_reads_per_solve.solve"] > 0
        assert got["scan_ms.solve"] > 0 and got["cleanup_ms.solve"] > 0
        assert len(prog["spans"]["cc.scan"]) == res["iterations"]
    else:
        assert got["host_reads_per_tick.churn"] > 0
        assert "solver.delete" in prog["spans"]
    assert "engine_ms.solve" in res["metrics"] or cell.endswith(".churn")
