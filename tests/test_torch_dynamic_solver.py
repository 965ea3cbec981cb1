"""repro_torch's Solver mutation path against repro.api.Solver: seeded
insert / delete scripts, policy-routed and with every forced
``delete_route``, with the returned version, labels, all five
WorkCounters, ``last_method``, ``stats``, ``num_edges``, the route
counts and the metrics summary equal after every batch (a fresh
in-memory autotune cache on each side; one with ``pallas_fused``
measured, so the policy routes deletes to the fused kernel); the opened
graph as the first bulk insert; bulk drops through a static rebuild;
``graph()``; the spanning-forest cache keyed on the label version; and
tracing that attaches the metrics. Integer work: the tolerance is 0."""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.connectivity import policy as jpolicy
from repro.obs import trace as jtrace
from repro_torch.connectivity import policy as tpolicy
from repro_torch.obs import trace as ttrace

ROUTES = (None, "tombstone-delete", "tombstone-delete-fused",
          "tombstone-delete-forest")


def _open(edges, n, cache_winner=None, **kw):
    jc, tc = jpolicy.AutotuneCache(None), tpolicy.AutotuneCache(None)
    if cache_winner is not None:
        for c in (jc, tc):
            c.record(n, 1, cache_winner, 1.0)
            for e in range(2, 4096):
                if c.lookup(n, e) is None:
                    c.record(n, e, cache_winner, 1.0)
    j = repro.Solver.open(edges, n, policy_cache=jc, **kw)
    t = repro_torch.Solver.open(edges, n, device="cpu", policy_cache=tc,
                                **kw)
    return j, t


def _assert_session(t, j, where=""):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels),
                                  err_msg=where)
    assert t.version == j.version, where
    assert t.work == j.work, where
    assert t.last_method == j.last_method, where
    assert t.stats == j.stats, where
    assert t.num_edges == j.num_edges, where
    assert repr(t) == repr(j)


@pytest.mark.parametrize("route", ROUTES, ids=str)
def test_mutation_script_matches_reference(route):
    rng = np.random.default_rng(7)
    n = 64
    base = rng.integers(0, n, (50, 2))
    j, t = _open(base, n, delete_route=route)
    j.enable_metrics()
    t.enable_metrics()
    _assert_session(t, j, "open")
    for step in range(10):
        e = rng.integers(0, n, (int(rng.integers(1, 20)), 2))
        vt, vj = t.insert(e), j.insert(e)
        assert isinstance(vt, torch.Tensor) and int(vt) == int(vj)
        _assert_session(t, j, f"insert {step}")
        live = np.asarray(j.state.log.edges)[np.asarray(j.state.log.alive)]
        # mostly small batches; every fourth a bulk drop (rebuild route
        # unless a route is forced)
        k = int(rng.integers(1, 6)) if step % 4 != 3 else len(live)
        dels = live[rng.integers(0, len(live), k)]
        if step % 2:
            dels = dels[:, ::-1]
        vt, vj = t.delete(dels), j.delete(dels)
        assert int(vt) == int(vj)
        _assert_session(t, j, f"delete {step}")
    assert t.state.delete_route_counts() == j.state.delete_route_counts()
    assert t.metrics_summary() == j.metrics_summary()
    gt, gj = t.graph(), j.graph()
    np.testing.assert_array_equal(gt.edges.numpy(), np.asarray(gj.edges))
    assert gt.true_edges == int(gj.true_edges)


def test_fused_route_from_the_autotune_cache():
    """A cache whose winner is ``pallas_fused`` routes small deletes to
    ``tombstone-delete-fused`` on both sides (road-like: tree ratio
    above 0.75, so not the forest)."""
    rng = np.random.default_rng(3)
    n = 200
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    j, t = _open(chain, n, cache_winner="pallas_fused")
    for step in range(4):
        e = rng.integers(0, n, (6, 2))
        t.insert(e)
        j.insert(e)
        dels = chain[rng.integers(0, n - 1, 3)]
        t.delete(dels)
        j.delete(dels)
        assert j.last_method == "tombstone-delete-fused"
        _assert_session(t, j, f"step {step}")
    assert t.state.scan_method == "pallas_fused"


def test_forced_scan_method_and_bad_route():
    n = 12
    edges = np.array([[i, i + 1] for i in range(n - 1)])
    j, t = _open(edges, n, scan_method="pallas_fused")
    for s in (j, t):
        s.insert([[0, 5]])
        s.delete([[2, 3]])
    _assert_session(t, j)
    assert t.state.scan_method == "pallas_fused"
    with pytest.raises(ValueError, match="delete_route"):
        repro_torch.Solver.open(None, 4, device="cpu", delete_route="x")
    with pytest.raises(ValueError, match="num_nodes"):
        t.insert(repro_torch.DeviceGraph.from_edges([[0, 1]], n + 1,
                                                    device="cpu"))
    with pytest.raises(ValueError, match="out of range"):
        t.delete([[0, n]])


def test_empty_session_and_device_graph_payloads():
    n = 20
    j = repro.Solver.open(None, n, policy_cache=jpolicy.AutotuneCache(None))
    t = repro_torch.Solver.open(None, n, device="cpu",
                                policy_cache=tpolicy.AutotuneCache(None))
    assert t.metrics is None and t.metrics_summary() is None
    assert t.graph().num_edges == 0 and t.version == 0
    from repro.graphs.device import DeviceGraph as JG
    rng = np.random.default_rng(1)
    for step in range(5):
        e = rng.integers(0, n, (8, 2)).astype(np.int32)
        t.insert(repro_torch.DeviceGraph.from_edges(e, n, device="cpu"))
        j.insert(JG.from_edges(e, n))
        _assert_session(t, j, f"insert {step}")
        t.delete(repro_torch.DeviceGraph.from_edges(e[:2], n, device="cpu"))
        j.delete(JG.from_edges(e[:2], n))
        _assert_session(t, j, f"delete {step}")
    # a bare session's first delete promotes it with an empty log
    j2 = repro.Solver.open(None, n, policy_cache=jpolicy.AutotuneCache(None))
    t2 = repro_torch.Solver.open(None, n, device="cpu",
                                 policy_cache=tpolicy.AutotuneCache(None))
    assert int(t2.delete([[0, 1]])) == int(j2.delete([[0, 1]])) == 0
    _assert_session(t2, j2)


def test_spanning_forest_cache_follows_the_version():
    n = 10
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    j, t = _open(edges, n)
    script = ([[5, 5]],            # promotes: the opened graph is adopted
              [[0, 2]],            # merges nothing: the forest is kept
              [[2, 3]])            # a merge: rebuilt
    forests = []
    for s in (j, t):
        got = []
        for e in script:
            s.insert(e)
            got.append(s.spanning_forest())
        s.delete([[9, 8]])         # any delete drops it
        got.append(s.spanning_forest())
        forests.append(got)
    ft = forests[1]
    assert ft[1] is ft[0] and ft[2] is not ft[1] and ft[3] is not ft[2]
    for fj, f in zip(*forests):
        np.testing.assert_array_equal(f.parents.numpy(),
                                      np.asarray(fj.parents))
        np.testing.assert_array_equal(f.labels.numpy(),
                                      np.asarray(fj.labels))
        assert f.work.as_ints() == {k: int(v) for k, v in
                                    fj.work._asdict().items()}


def test_tracing_on_before_the_first_mutation_attaches_metrics():
    n = 30
    rng = np.random.default_rng(2)
    edges = rng.integers(0, n, (40, 2))
    batches = [rng.integers(0, n, (5, 2)) for _ in range(3)]
    jtrace.enable()
    ttrace.enable()
    try:
        j, t = _open(edges, n, delete_route="tombstone-delete-forest")
        for s in (j, t):
            for b in batches:
                s.insert(b)
                s.delete(b[:2])
        assert t.metrics is not None
        assert t.metrics_summary() == j.metrics_summary()
        _assert_session(t, j)
        names = [e["name"] for e in ttrace.tracer().log.events()]
        assert "solver.insert" in names and "solver.delete" in names
    finally:
        jtrace.disable()
        ttrace.disable()
    assert t.state.delete_route_counts() == j.state.delete_route_counts()
