"""repro_torch's multi-shard engine against repro.core.distributed: the
port at 1, 2, 3 and 8 CPU slots gives the union-find oracle's labels and
the reference's single-device ``solve`` labels on the reference's own
cases (row counts that do not divide included); ``DeviceGraph.shard``
pads as the reference's does; the rounds stay within ``_MAX_ROUNDS``;
the runner cache counts hits and misses as the reference's does; mesh
sessions plan, and refuse, as the reference's; and one subprocess runs
the reference on 8 forced host devices against the port's 8 slots.
Integer work: the tolerance is 0."""
import json

import jax
import numpy as np
import pytest
import torch

import repro
from repro.api.plan import ExecutionPlan as JPlan
from repro.core import distributed as jdist
from repro.graphs import device as jdev
from repro.graphs import generators as jgen
from repro.launch.mesh import make_cpu_mesh
import repro_torch
from repro_torch.api.plan import ExecutionPlan as TPlan
from repro_torch.core import distributed as tdist
from repro_torch.core.unionfind import connected_components_oracle
from repro_torch.graphs import device as tdev
from repro_torch.graphs import generators as tgen
from repro_torch.launch.mesh import Mesh, make_mesh

from test_distributed import run_sub

SLOTS = (1, 2, 3, 8)
CASES = {
    "rmat": lambda m: m.rmat(6, 4, seed=2),
    "grid_road": lambda m: m.grid_road(7, seed=3),
    "star": lambda m: m.star(13),
    "disjoint_cliques": lambda m: m.disjoint_cliques(3, 5, seed=1),
}


def _cpu_mesh(k: int) -> Mesh:
    return make_mesh(k, device="cpu")


@pytest.mark.parametrize("k", SLOTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_solve_matches_oracle_and_reference(case, k):
    g = CASES[case](tgen)
    assert any(CASES[c](tgen).num_edges % 8 for c in CASES)
    res = repro_torch.Solver.open(g, mesh=_cpu_mesh(k)).solve()
    want = connected_components_oracle(g.edges, g.num_nodes)
    single = np.asarray(repro.solve(g.edges, g.num_nodes).labels)
    assert res.labels.dtype == torch.int32
    np.testing.assert_array_equal(res.labels.numpy(), want)
    np.testing.assert_array_equal(res.labels.numpy(), single)
    assert set(res.work.as_ints().values()) == {0}


@pytest.mark.parametrize("k", SLOTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_pads_to_a_multiple_of_the_slots(case, k):
    g = CASES[case](tgen)
    dg = tdev.DeviceGraph.from_host(g, device="cpu").shard(_cpu_mesh(k))
    e = g.num_edges
    per = max(1, -(-e // k))
    assert dg.edges.shape[0] == per * k and dg.edges.shape[0] % k == 0
    assert len(dg.shards) == k
    assert all(s.shape == (per, 2) and s.device.type == "cpu"
               for s in dg.shards)
    np.testing.assert_array_equal(torch.cat(dg.shards).numpy(),
                                  dg.edges.numpy())
    np.testing.assert_array_equal(dg.edges[:e].numpy(), g.edges)
    assert not dg.edges[e:].any()
    # the reference's shard is its pad_rows to per * n, then placement
    jg = jdev.DeviceGraph.from_host(CASES[case](jgen)).pad_rows(per * k)
    assert vars(dg.plan) == vars(jg.plan)
    assert (dg.true_edges, dg.name, dg.degree_skew) == \
        (jg.true_edges_static, jg.name, jg.degree_skew)


@pytest.mark.parametrize("k", SLOTS)
def test_rounds_stay_within_max_rounds(k):
    for case in sorted(CASES):
        g = CASES[case](tgen)
        dg = tdev.DeviceGraph.from_host(g, device="cpu").shard(_cpu_mesh(k))
        fn = tdist.build_distributed_cc(dg, _cpu_mesh(k))
        labels = fn(dg)
        assert 1 <= fn.last_rounds <= tdist._MAX_ROUNDS == jdist._MAX_ROUNDS
        np.testing.assert_array_equal(
            labels.numpy(), connected_components_oracle(g.edges, g.num_nodes))
        # the edges-level entry gives the same labels, unsharded graphs
        # of the same row count are sharded on the way in
        np.testing.assert_array_equal(fn.on_edges(dg.edges).numpy(),
                                      labels.numpy())
        unsharded = tdev.DeviceGraph(dg.edges, dg.num_nodes, dg.true_edges,
                                     dg.plan)
        np.testing.assert_array_equal(fn(unsharded).numpy(), labels.numpy())


def test_max_rounds_caps_the_loop(monkeypatch):
    """A cap below the rounds a graph needs stops the loop there, as the
    reference's while_loop does (labels then need not be final)."""
    g = tgen.grid_road(12, seed=1)
    mesh = _cpu_mesh(4)
    dg = tdev.DeviceGraph.from_host(g, device="cpu").shard(mesh)
    fn = tdist.build_distributed_cc(dg, mesh, local_segments=8)
    fn(dg)
    need = fn.last_rounds
    assert need >= 2
    monkeypatch.setattr(tdist, "_MAX_ROUNDS", need - 1)
    fn(dg)
    assert fn.last_rounds == need - 1


def test_runner_cache_counts_match_reference():
    """The same call sequence through both caches (one slot, so both
    shard to the same row counts): equal hits and misses after every
    call, equal labels."""
    jcache = jdist.DistributedRunnerCache(make_cpu_mesh(1), ("data",))
    tcache = tdist.DistributedRunnerCache(_cpu_mesh(1), ("data",))
    seq = ["rmat", "rmat", "star", "grid_road", "star", "rmat",
           "disjoint_cliques", "grid_road"]
    for case in seq:
        jg = jdev.DeviceGraph.from_host(CASES[case](jgen))
        tg = tdev.DeviceGraph.from_host(CASES[case](tgen), device="cpu")
        want = np.asarray(jcache.solve(jg))
        got = tcache.solve(tg)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=case)
        assert tcache.stats == jcache.stats, case
    # runner() on an already-sharded graph hits the same bucket
    tg = tdev.DeviceGraph.from_host(CASES["star"](tgen), device="cpu")
    jg = jdev.DeviceGraph.from_host(CASES["star"](jgen))
    tcache.runner(tg.shard(tcache.mesh))
    jcache.runner(jg.shard(jcache.mesh))
    assert tcache.stats == jcache.stats == {"hits": 5, "misses": 4}


def test_mesh_plans_and_errors_match_reference():
    g = CASES["grid_road"](tgen)
    jmesh, tmesh = make_cpu_mesh(1), _cpu_mesh(2)
    j = repro.Solver.open(g.edges, g.num_nodes, mesh=jmesh)
    t = repro_torch.Solver.open(g.edges, g.num_nodes, mesh=tmesh)
    for kw in ({}, {"method": "adaptive"}, {"backend": "distributed"},
               {"backend": "pallas_fused"}):
        jp, tp = j.plan(**kw), t.plan(**kw)
        assert (tp.backend, tp.reason) == (jp.backend, jp.reason), kw
        assert tp.as_dict() == jp.as_dict(), kw
        assert tp.opts["mesh"] is tmesh
        assert tp.opts["axis_names"] == jp.opts["axis_names"] == ("data",)
    assert t.solve("adaptive").work.as_ints() == {
        k: int(v) for k, v in j.solve("adaptive").work._asdict().items()}
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert t.last_method == j.last_method == "adaptive"
    # without a mesh: the plan routes by the policy, a forced sharded
    # backend raises, alike
    j0 = repro.Solver.open(g.edges, g.num_nodes)
    t0 = repro_torch.Solver.open(g.edges, g.num_nodes, device="cpu")
    assert (t0.plan().backend, t0.plan().reason) == \
        (j0.plan().backend, j0.plan().reason)
    assert t0.plan().opts == {"mesh": None, "axis_names": ("data",)}
    with pytest.raises(ValueError) as jerr:
        j0.solve(backend="distributed")
    with pytest.raises(ValueError) as terr:
        t0.solve(backend="distributed")
    assert str(terr.value) == str(jerr.value)
    # the backend itself, handed a plan with no mesh
    kw = dict(backend="distributed", reason="forced", num_nodes=4,
              num_edges=0, bucket=(8, 8), segmentation=None)
    with pytest.raises(ValueError) as jerr:
        repro.get_backend("distributed").run(JPlan(**kw))
    with pytest.raises(ValueError) as terr:
        repro_torch.get_backend("distributed").run(TPlan(**kw))
    assert str(terr.value) == str(jerr.value)


def test_engine_refusals():
    mesh = _cpu_mesh(8)
    g = tdev.DeviceGraph.from_edges(np.zeros((13, 2), np.int32), 4,
                                    device="cpu")
    with pytest.raises(ValueError, match="edge count 13 does not divide "
                                         "into 8 shards; shard the graph "
                                         "with DeviceGraph.shard"):
        tdist.build_distributed_cc(g, mesh)
    fn = tdist.build_distributed_cc(g.shard(mesh), mesh)
    with pytest.raises(ValueError, match="built for 16 rows"):
        fn.on_edges(torch.zeros((8, 2), dtype=torch.int32))
    # int32 extents are checked before anything is allocated
    meta = tdev.DeviceGraph(
        torch.empty((2**31, 2), dtype=torch.int32, device="meta"), 4, 0,
        g.plan)
    with pytest.raises(ValueError, match="rows = 2147483648 does not fit "
                                         "int32"):
        tdist.build_distributed_cc(meta, make_mesh(1, device="cpu"))
    with pytest.raises(ValueError, match="does not fit int32"):
        tdist.build_distributed_cc(
            tdev.DeviceGraph(torch.empty((8, 2), dtype=torch.int32,
                                         device="meta"), 2**31, 0, g.plan),
            make_mesh(1, device="cpu"))
    huge = tdev.DeviceGraph(
        torch.empty((2**31 - 1, 2), dtype=torch.int32, device="meta"), 4,
        0, g.plan)
    with pytest.raises(ValueError, match="rows = 2147483648 does not fit"):
        huge.shard(make_mesh(2, device="cpu"))


def test_mesh_helpers():
    m = Mesh([["cpu", "cpu"], ["cpu", "cpu"], ["cpu", "cpu"]],
             ("data", "model"))
    assert m.shape == {"data": 3, "model": 2} and m.size == 6
    assert len(m.slot_devices()) == 6
    assert len(m.slot_devices(("data",))) == 3
    assert len(m.slot_devices(("model",))) == 2
    with pytest.raises(ValueError, match="not in the mesh"):
        m.slot_devices(("pod",))
    with pytest.raises(ValueError, match="do not match"):
        Mesh(["cpu"] * 4, ("data", "model"))
    # a 3x2 mesh sharded over both axes equals the oracle
    g = CASES["rmat"](tgen)
    res = repro_torch.solve(g.edges, g.num_nodes, mesh=m,
                            axis_names=("data", "model"))
    np.testing.assert_array_equal(
        res.labels.numpy(), connected_components_oracle(g.edges, g.num_nodes))
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    for multi in (False, True):
        assert tmesh.fsdp_axes(multi) == jmesh.fsdp_axes(multi)
        assert tmesh.all_axes(multi) == jmesh.all_axes(multi)
    with pytest.raises(NotImplementedError, match="A11.5"):
        tmesh.make_production_mesh()


def test_make_mesh_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2)
    g = CASES["star"](tgen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Solver.open(g, mesh=make_mesh(2))
    assert make_mesh(3, device="cpu").slot_devices() == \
        (torch.device("cpu"),) * 3


def test_reference_on_8_host_devices_matches_port_8_slots():
    """The reference's ``Solver.open(g, mesh=<8 forced host
    devices>).solve()`` in a subprocess (as ``test_distributed`` runs
    it), against the port's 8-slot solve: equal labels on every case,
    equal runner-cache counts over one call sequence."""
    out = run_sub("""
        import json
        from repro.api import Solver
        from repro.core.distributed import (DistributedRunnerCache,
                                            build_distributed_cc)
        from repro.graphs.device import DeviceGraph
        from repro.graphs.generators import (disjoint_cliques, grid_road,
                                             rmat, star)
        assert len(jax.devices()) == 8
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
        cases = {"rmat": rmat(6, 4, seed=2), "grid_road": grid_road(7, seed=3),
                 "star": star(13), "disjoint_cliques":
                 disjoint_cliques(3, 5, seed=1)}
        labels = {name: np.asarray(Solver.open(g, mesh=mesh).solve().labels)
                  .tolist() for name, g in cases.items()}
        cache = DistributedRunnerCache(mesh, ("data",))
        stats = []
        for name in ("star", "rmat", "star", "grid_road", "rmat"):
            cache.solve(DeviceGraph.from_host(cases[name]))
            stats.append(dict(cache.stats))
        try:
            build_distributed_cc(DeviceGraph.from_edges(
                np.zeros((13, 2), np.int32), 4), mesh)
        except ValueError as err:
            msg = str(err)
        print("REF_8DEV " + json.dumps({"labels": labels, "stats": stats,
                                        "msg": msg}))
    """)
    line = [ln for ln in out.splitlines() if ln.startswith("REF_8DEV ")]
    ref = json.loads(line[0][len("REF_8DEV "):])
    mesh = _cpu_mesh(8)
    for name, make in CASES.items():
        got = repro_torch.Solver.open(make(tgen), mesh=mesh).solve().labels
        np.testing.assert_array_equal(got.numpy(), ref["labels"][name],
                                      err_msg=name)
    cache = tdist.DistributedRunnerCache(mesh, ("data",))
    stats = []
    for name in ("star", "rmat", "star", "grid_road", "rmat"):
        cache.solve(tdev.DeviceGraph.from_host(CASES[name](tgen),
                                               device="cpu"))
        stats.append(dict(cache.stats))
    assert stats == ref["stats"]
    with pytest.raises(ValueError) as err:
        tdist.build_distributed_cc(tdev.DeviceGraph.from_edges(
            np.zeros((13, 2), np.int32), 4, device="cpu"), mesh)
    assert str(err.value) == ref["msg"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_distributed_entry_matches_reference(case):
    """The engine-level entry on a host graph (placed on slot 0's
    device) and on an unsharded DeviceGraph, against the reference's
    ``solve_distributed``; the backend records its rounds."""
    want = np.asarray(jdist.solve_distributed(CASES[case](jgen),
                                              make_cpu_mesh(1)))
    g = CASES[case](tgen)
    for k in (1, 3):
        got = tdist.solve_distributed(g, _cpu_mesh(k))
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        dg = tdev.DeviceGraph.from_host(g, device="cpu")
        np.testing.assert_array_equal(
            tdist.solve_distributed(dg, _cpu_mesh(k)).numpy(), want)
    s = repro_torch.Solver.open(g, mesh=_cpu_mesh(3))
    s.solve()
    assert 1 <= s.last_plan.artifacts["rounds"] <= 8
