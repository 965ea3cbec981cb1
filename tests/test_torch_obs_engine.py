"""The tracer inside the port's CC and dynamic engines: the read-back
counters (``obs.read``) against the work the same call billed, the
phase spans and how they nest, and span starts on the clock that
``torch.profiler`` stamps its ranges with."""
import numpy as np
import pytest
import torch

from repro_torch.api import Solver
from repro_torch.connectivity import policy
from repro_torch.core import rounds
from repro_torch.obs import trace as obs

V = 3000


def _edges(n: int, e: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n, (e, 2)).astype(
        np.int32)


def _reads(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k.startswith("read.")}


@pytest.fixture
def tracer():
    tr = obs.tracer()
    tr.reset()
    yield tr
    obs.disable()
    tr.reset()


def _session(route: str) -> Solver:
    """A session opened on a sparse graph (many components, so inserts
    merge and deletes split), its bulk first insert done."""
    s = Solver.open(_edges(V, 2500, 1), V, device="cpu", delete_route=route)
    s.state
    return s


def _call(kind: str):
    """(the call, the work it billed) for one engine path; the work is
    read after the call, outside the count, and checks the route."""
    if kind == "solve":
        plan = Solver.open(_edges(V, 9000, 2), V, device="cpu").plan(
            "adaptive")
        out = {}

        def run():
            out["work"] = plan.run().work.as_ints()
        return run, lambda: out["work"]
    route = policy.DYNAMIC_DELETE_FOREST if kind == "forest" \
        else policy.DYNAMIC_DELETE
    s = _session(route)
    before = s.work
    if kind == "absorb":
        run = lambda: s.insert(_edges(V, 300, 3))            # noqa: E731
        want = policy.INCREMENTAL_ABSORB
    else:
        run = lambda: s.delete(_edges(V, 2500, 1)[:400])     # noqa: E731
        want = route

    def billed():
        assert s.last_method == want
        return {k: v - before[k] for k, v in s.work.items()}
    return run, billed


@pytest.mark.parametrize("kind", ["solve", "absorb", "scoped", "forest"])
def test_sweep_reads_equal_the_billed_jump_sweeps(tracer, kind):
    """Every compress sweep reads its changed flag back once: the count
    of ``read.sweep`` is the ``jump_sweeps`` the same call billed."""
    run, billed = _call(kind)
    tracer.reset()
    run()
    sweeps = tracer.counters.get("read.sweep", 0)
    work = billed()
    assert work["jump_sweeps"] > 0
    assert sweeps == work["jump_sweeps"]


@pytest.mark.parametrize("n,e,seed", [(3000, 9000, 2), (512, 4000, 5),
                                      (4096, 2048, 7)])
def test_adaptive_solve_reads_back_the_fig4_count(tracer, n, e, seed):
    """An ``adaptive`` solve reads the segment counts once, each sweep's
    flag once, and the consistency flag once before the cleanup and
    once after each cleanup round: 2 + jump_sweeps + hook_rounds -
    segments, and nothing else."""
    plan = Solver.open(_edges(n, e, seed), n, device="cpu").plan("adaptive")
    tracer.reset()
    work = plan.run().work.as_ints()
    segments = plan.segmentation.num_segments
    reads = _reads(tracer.counters)
    assert set(reads) == {"read.scan_counts", "read.sweep",
                          "read.consistent"}
    assert sum(reads.values()) == \
        2 + work["jump_sweeps"] + work["hook_rounds"] - segments


def _contains(outer: dict, inner: dict, slack_us: float = 50.0) -> bool:
    return (outer["ts_us"] - slack_us <= inner["ts_us"] and
            inner["ts_us"] + inner["dur_us"]
            <= outer["ts_us"] + outer["dur_us"] + slack_us and
            inner["depth"] > outer["depth"])


def test_engine_spans_nest_and_tracing_off_records_none(tracer):
    plan = Solver.open(_edges(V, 9000, 2), V, device="cpu").plan("adaptive")
    s = _session(policy.DYNAMIC_DELETE_FOREST)
    dels = _edges(V, 2500, 1)[:400]
    # off: the counters count, no span is recorded
    tracer.reset()
    plan.run()
    assert len(tracer.log) == 0 and tracer.counters["read.sweep"] > 0
    assert not any(k.startswith("read_ns.") for k in tracer.counters)
    obs.enable()
    plan.run()
    s.delete(dels)
    obs.disable()
    ev = {}
    for e in tracer.log.events():
        ev.setdefault(e["name"], []).append(e)
    run, delete = ev["plan.run"][0], ev["solver.delete"][0]
    assert _contains(run, ev["cc.scan"][0])
    assert _contains(run, ev["cc.cleanup"][0])
    work = plan.run().work.as_ints()    # tracing off again: same work
    scan, cleanup = ev["cc.scan"][0]["tags"], ev["cc.cleanup"][0]["tags"]
    assert scan == {"segments": plan.segmentation.num_segments,
                    "sweeps": scan["sweeps"]}
    assert set(cleanup) == {"rounds", "sweeps"}
    assert scan["sweeps"] + cleanup["sweeps"] == work["jump_sweeps"]
    assert scan["segments"] + cleanup["rounds"] == work["hook_rounds"]
    for name in ("dyn.tombstone", "dyn.forest.rebuild",
                 "dyn.forest.skeleton", "dyn.forest.replace"):
        assert _contains(delete, ev[name][0]), name
    skel = ev["dyn.forest.skeleton"][0]["tags"]
    assert 0 < skel["rows"] < V and skel["segments"] == -(-V // 1024)
    assert ev["dyn.forest.replace"][0]["tags"]["rows"] >= 0
    # the phases run one after another
    assert ev["dyn.forest.skeleton"][0]["ts_us"] <= \
        ev["dyn.forest.replace"][0]["ts_us"]
    # while on, the reads' blocked time is summed beside their count
    assert tracer.counters["read_ns.sweep"] > 0
    assert all(n.startswith(obs.PORT_ONLY) for n in ev
               if n not in ("plan.run", "solver.delete", "policy.select_for"))


def test_scoped_delete_spans(tracer):
    s = _session(policy.DYNAMIC_DELETE)
    obs.enable()
    s.delete(_edges(V, 2500, 1)[:400])
    obs.disable()
    names = [e["name"] for e in tracer.log.events()]
    assert names.index("dyn.tombstone") < names.index("dyn.scoped") \
        < names.index("solver.delete")


def test_a_span_starts_where_its_profiler_range_starts(tracer):
    """``ts_us`` is on the clock of the profiler's host events: a span's
    start and its ``record_function`` range's start agree within 50 us
    in a CPU profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    obs.enable(torch_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):          # the first range pays for its set-up
            with obs.span("warm"):
                pass
        with obs.span("probe"):
            torch.arange(64).sum()
    obs.disable()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (rng,) = [e for e in prof.events() if e.name == "probe"]
    (span,) = [e for e in tracer.log.events() if e["name"] == "probe"]
    prof_us = start_ns / 1e3 + rng.time_range.start
    assert abs(span["ts_us"] - prof_us) < 50.0


def test_port_only_names_cover_the_new_spans_and_counters():
    for name in ("read.sweep", "read_ns.sweep", "solver.open",
                 "solver.plan", "cc.scan", "cc.cleanup", "dyn.tombstone",
                 "dyn.scoped", "dyn.forest.rebuild", "dyn.forest.skeleton",
                 "dyn.forest.replace", "read.scan_sweeps"):
        assert name.startswith(obs.PORT_ONLY)
    for name in ("plan.run", "solver.solve", "solver.insert",
                 "solver.delete", "service.tick", "autotune.hit",
                 "dynamic.deletes.rebuild"):
        assert not name.startswith(obs.PORT_ONLY)


def test_work_drains_are_told_apart(tracer):
    """The amortised drain of the work queue is the engine's own read
    (``read.drain``); a read of ``work`` is introspection
    (``read.work``)."""
    s = _session(policy.DYNAMIC_DELETE)
    tracer.reset()
    s.work
    assert _reads(tracer.counters) == {"read.work": 1}
    dyn = s.state
    tracer.reset()
    for i in range(256):
        dyn.insert(_edges(V, 2, 100 + i))
    assert tracer.counters.get("read.drain") == 1
    assert "read.work" not in tracer.counters


@pytest.mark.parametrize("num_nodes,engages", [(2_097_152, True),
                                                (23_990_404, False),
                                                (173_976_100, False)])
def test_forest_device_loop_gate_is_pi_and_its_buffer_in_the_l2(
        num_nodes, engages):
    """The gate reads |V| and the L2 alone: at the H100's 52,428,800 B,
    kron-logn21's π and its Jacobi double buffer (8 B a vertex) fit;
    usa-road's and euro-road's do not."""
    assert rounds.forest_scan_fits_l2(num_nodes, 52_428_800) is engages


def test_a_cpu_forest_session_never_reaches_the_kernel_wrapper(
        tracer, monkeypatch):
    """On the CPU the forest rebuild and the skeleton phase keep the
    host loop: the kernel wrapper is never called, no sweep sum is read
    back, and both spans say so."""
    from repro_torch.kernels.cc_fused import ops as cc_ops

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel wrapper")
    monkeypatch.setattr(cc_ops, "fused_forest_scan", refuse)
    launches = cc_ops.FOREST.launches
    s = _session(policy.DYNAMIC_DELETE_FOREST)
    obs.enable()
    s.delete(_edges(V, 2500, 1)[:400])
    obs.disable()
    assert s.last_method == policy.DYNAMIC_DELETE_FOREST
    assert rounds.forest_scan_loop(V, "cpu") == "host"
    tags = {e["name"]: e.get("tags", {}) for e in tracer.log.events()}
    assert tags["dyn.forest.rebuild"]["loop"] == "host"
    assert tags["dyn.forest.skeleton"]["loop"] == "host"
    assert "read.scan_sweeps" not in tracer.counters
    assert tracer.counters["read.sweep"] > 0
    assert cc_ops.FOREST.launches == launches


@pytest.mark.cuda
def test_graphed_segment_sweep_reads_equal_the_billed_sweeps(
        tracer, monkeypatch):
    """On the card, where the device loop's gate is off, the full
    segments of the id-recording scan replay as CUDA graphs: their flag
    reads still count one a sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graphs have no CPU mode")
    monkeypatch.setattr(rounds, "forest_scan_fits_l2", lambda *a: False)
    dev = torch.device("cuda")
    n, seg = 1 << 14, 1024
    edges = torch.from_numpy(_edges(n, 8 * seg, 11)).to(dev)
    ids = torch.arange(edges.shape[0], dtype=torch.int32, device=dev)
    tracer.reset()
    pi, _, _, work = rounds.forest_scan_rounds_ids(
        torch.arange(n, dtype=torch.int32, device=dev),
        rounds.empty_forest(n, dev), rounds.empty_forest_idx(n, dev),
        edges, ids, edges.shape[0], rounds.WorkCounters.zeros(dev),
        lift_steps=0, segment_size=seg)
    sweeps = int(work.jump_sweeps)
    assert sweeps > 8
    assert tracer.counters["read.sweep"] == sweeps
