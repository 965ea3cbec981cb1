"""repro_torch's front door against repro.api: the capability matrix of
every backend the port registers; ``Solver.plan()`` choosing the same
backend for the same reason, and ``solve()`` giving equal labels and
WorkCounters on every registered backend, over the named corpus and the
Table I stand-ins at scale 0.002 (a fresh in-memory autotune cache on
each side); ``solve_static(method="auto")``; the autotune cache's keys
and file round trip; the queries through the session; the session
features of the later slices. Integer work: the tolerance is 0."""
import json

import numpy as np
import pytest
import torch

import repro
from _graphgen import corpus
from repro.connectivity import policy as jpolicy
from repro.core import cc as jcc
from repro.graphs.generators import table1_scaled
import repro_torch
from repro_torch.connectivity import policy as tpolicy
from repro_torch.core import cc as tcc
from repro_torch.launch.mesh import make_mesh

NOT_PORTED = set()
GRAPHS = [(name, n, e) for name, n, e in corpus()] + [
    (f"{name}@0.002", g.num_nodes, g.edges) for name, g in
    ((name, table1_scaled(name, scale=0.002, seed=1))
     for name in ("usa-osm", "euro-osm-karls", "soc-live-journal",
                  "kron-logn21"))]
GIDS = [g[0] for g in GRAPHS]


def _ints(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


def _open(n, edges):
    """The same graph opened on each side, each with a cold cache."""
    j = repro.Solver.open(edges, n, policy_cache=jpolicy.AutotuneCache(None))
    t = repro_torch.Solver.open(edges, n, device="cpu",
                                policy_cache=tpolicy.AutotuneCache(None))
    return j, t


def test_capability_matrix_matches_reference():
    got, want = repro_torch.capability_matrix(), repro.capability_matrix()
    assert set(want) - set(got) == NOT_PORTED
    assert set(got) <= set(want)
    for name, caps in got.items():
        assert caps == want[name], name
    assert repro_torch.available_backends() == sorted(got)
    assert isinstance(repro_torch.get_backend("sampled"), repro_torch.Backend)
    assert repro_torch.get_backend("distributed").capabilities.sharded
    with pytest.raises(KeyError, match="no-such-backend"):
        repro_torch.get_backend("no-such-backend")


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=GIDS)
def test_solver_plans_and_solves_match_reference(name, n, edges):
    j, t = _open(n, edges)
    jp, tp = j.plan(), t.plan()
    assert (tp.backend, tp.reason) == (jp.backend, jp.reason)
    assert tp.as_dict() == jp.as_dict()
    assert tp.explain() == jp.explain()
    assert tp.trace_tags() == jp.trace_tags()
    for backend in repro_torch.available_backends():
        caps = repro_torch.get_backend(backend).capabilities
        if caps.batched or caps.sharded:
            # a fleet backend, or one that needs a mesh these sessions
            # lack: both sessions refuse it, alike
            with pytest.raises(ValueError) as jerr:
                j.solve(backend=backend)
            with pytest.raises(ValueError) as terr:
                t.solve(backend=backend)
            assert str(terr.value) == str(jerr.value)
            continue
        want = j.solve(backend=backend)
        got = t.solve(backend=backend)
        assert got.labels.dtype == torch.int32, backend
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels),
                                      err_msg=backend)
        assert got.work.as_ints() == _ints(want.work), backend
        if backend == "pallas":
            assert set(got.work.as_ints().values()) == {0}
        for key in ("sampled_stats", "hostloop_stats"):
            assert t.last_plan.artifacts.get(key) == \
                j.last_plan.artifacts.get(key), (backend, key)
    assert t.last_method == j.last_method
    # the default route, then the queries over the session's labels
    got, want = t.solve(), j.solve()
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.work.as_ints() == _ints(want.work)
    assert t.num_components() == j.num_components()
    np.testing.assert_array_equal(t.component_histogram(),
                                  j.component_histogram())
    if n:
        rng = np.random.default_rng(n)
        pairs = rng.integers(0, n, (13, 2))
        vertices = rng.integers(0, n, 11)
        np.testing.assert_array_equal(t.same_component(pairs),
                                      j.same_component(pairs))
        np.testing.assert_array_equal(t.component_size(vertices),
                                      j.component_size(vertices))
        np.testing.assert_array_equal(t.component_sizes().numpy(),
                                      np.asarray(j.component_sizes()))
        assert t.connected(0, n - 1) == j.connected(0, n - 1)


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=GIDS)
def test_solve_static_auto_matches_reference(monkeypatch, name, n, edges):
    monkeypatch.setattr(jpolicy, "_default_cache", jpolicy.AutotuneCache())
    monkeypatch.setattr(tpolicy, "_default_cache", tpolicy.AutotuneCache())
    want = jcc.solve_static(edges, n, "auto")
    got = tcc.solve_static(edges, n, "auto", device="cpu")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.work.as_ints() == _ints(want.work)
    got = repro_torch.solve(edges, n, device="cpu",
                            policy_cache=tpolicy.AutotuneCache())
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


def test_autotune_cache_keys_and_file_round_trip(tmp_path):
    for v, e in ((0, 0), (1, 1), (9, 17), (1000, 3900), (2**20 + 1, 5 * 2**20),
                 (23947347, 28854312), (2097152, 45088768)):
        assert tpolicy.AutotuneCache.key(v, e) == \
            jpolicy.AutotuneCache.key(v, e)
    path = str(tmp_path / "sub" / "cache.json")
    cache = tpolicy.AutotuneCache(path)
    cache.record(1000, 3900, "sampled", 1.234567)
    cache.record(20, 30, "adaptive", 0.5)
    with open(path) as fh:
        payload = json.load(fh)
    assert payload["version"] == tpolicy.CACHE_FORMAT_VERSION
    again = tpolicy.AutotuneCache(path)
    assert again.entries == cache.entries
    assert again.lookup(1000, 3900) == "sampled"
    want = jpolicy.AutotuneCache(None)
    want.record(1000, 3900, "sampled", 1.234567)
    assert want.entries[want.key(1000, 3900)] == \
        again.entries[again.key(1000, 3900)]


def test_autotune_measure_routes_plans(monkeypatch, tmp_path):
    """A CPU graph times the torch-op engines only, records the winner,
    and the next plan for that bucket reports ``autotune``."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "c.json"))
    monkeypatch.setattr(tpolicy, "_default_cache", None)
    cache = tpolicy.default_cache()
    assert cache.path == str(tmp_path / "c.json")
    name, n, edges = GRAPHS[GIDS.index("er-mid")]
    winner = cache.measure(edges, n, reps=1, device="cpu")
    assert set(cache.last_timings) == set(tpolicy.STATIC_METHODS)
    assert winner == min(cache.last_timings, key=cache.last_timings.get)
    s = repro_torch.Solver.open(edges, n, device="cpu")
    plan = s.plan()
    assert (plan.backend, plan.reason) == (winner, "autotune")
    assert json.load(open(tmp_path / "c.json"))["entries"]
    want = jcc.solve_static(edges, n, winner)
    np.testing.assert_array_equal(s.solve().labels.numpy(),
                                  np.asarray(want.labels))
    # warm_start measures each unrecorded bucket once
    from repro_torch.graphs.format import Graph
    graphs = [Graph(edges=e, num_nodes=v) for _, v, e in
              (GRAPHS[GIDS.index(k)] for k in ("er-mid", "star-13"))]
    warm = tpolicy.warm_start(graphs, tpolicy.AutotuneCache(), reps=1,
                              device="cpu")
    assert sorted(warm.entries) == sorted(
        {warm.key(g.num_nodes, g.num_edges) for g in graphs})
    assert warm.entries[warm.key(n, len(edges))]["num_edges"] == len(edges)


@pytest.mark.parametrize("delta,deletes", [(None, None), (5, None),
                                           (400, None), (None, 3),
                                           (None, 300)])
def test_policy_routes_match_reference(delta, deletes):
    for v, e, skew in ((100, 400, None), (1000, 5000, 20.0), (10, 100, 1.0),
                       (1000, 1000, 1.0), (5000, 4000, 2.0)):
        got = tpolicy.select_method(v, e, delta_edges=delta,
                                    delta_deletes=deletes, degree_skew=skew,
                                    cache=tpolicy.AutotuneCache())
        want = jpolicy.select_method(v, e, delta_edges=delta,
                                     delta_deletes=deletes, degree_skew=skew,
                                     cache=jpolicy.AutotuneCache())
        assert got == want
        f = tpolicy.extract_features(v, e, delta, deletes, skew)
        assert tpolicy.heuristic_method(f) == jpolicy.heuristic_method(
            jpolicy.extract_features(v, e, delta, deletes, skew))


def test_spanning_forest_falls_back_to_adaptive():
    name, n, edges = GRAPHS[GIDS.index("er-dense")]
    j, t = _open(n, edges)
    assert t.plan().backend == j.plan().backend == "labelprop"
    got, want = t.spanning_forest(), j.spanning_forest()
    np.testing.assert_array_equal(got.parents.numpy(),
                                  np.asarray(want.parents))
    np.testing.assert_array_equal(
        got.parents.numpy(),
        np.asarray(jcc.solve_forest(edges, n, "adaptive").parents))
    assert t.spanning_forest() is got          # cached per method
    got = t.spanning_forest("sampled")
    np.testing.assert_array_equal(got.parents.numpy(),
                                  np.asarray(j.spanning_forest(
                                      "sampled").parents))
    with pytest.raises(ValueError, match="spanning forest"):
        t.spanning_forest("pallas_fused")


def test_session_state_of_a_static_session():
    name, n, edges = GRAPHS[GIDS.index("chain-17")]
    j, t = _open(n, edges)
    assert t.version == j.version == 0
    assert int(t.version_device) == 0 and t.version_device.dtype == torch.int32
    assert t.work == j.work
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert t.stats["solves"] == 0 and t.last_plan is None
    assert repr(t) == repr(j)
    empty = repro_torch.Solver.open(None, 5, device="cpu")
    np.testing.assert_array_equal(empty.labels.numpy(), np.arange(5))
    assert empty.plan().num_edges == 0
    with pytest.raises(ValueError, match="vertex out of range"):
        t.connected(0, n)
    with pytest.raises(ValueError, match="not both"):
        t.plan("adaptive", backend="sampled")
    with pytest.raises(TypeError, match="unknown option"):
        t.plan(interpret=True)
    with pytest.raises(ValueError, match="unknown method"):
        t.plan("no-such-method")


@pytest.mark.parametrize("call,item", [
    (lambda s: s.insert([[0, 1]]), "A6"),
    (lambda s: s.delete([[0, 1]]), "A6"),
    (lambda s: s.enable_metrics(), "A6"),
    (lambda s: s.metrics_summary(), "A6"),
    (lambda s: repro_torch.Solver.open(
        s.graph(), mesh=make_mesh(2, device="cpu")).solve(), "A10"),
])
def test_unported_session_features_raise(call, item):
    """The session features of the later slices run now, none raises:
    the A6 features (the mutation path and its metrics) and the A10
    ``mesh=`` session (the multi-shard engine)."""
    s = repro_torch.Solver.open([[0, 1], [1, 2]], 4, device="cpu")
    out = call(s)
    if item == "A6":
        assert s.state is not None and s.stats["inserts"] >= 1
        return
    np.testing.assert_array_equal(out.labels.numpy(), [0, 0, 0, 3])


def test_solve_batch_runs_and_batched_backend_is_fleet_only():
    """``Solver.solve_batch`` runs (A8 is ported); forcing the fleet
    backend on one graph raises the reference's ValueError."""
    s = repro_torch.Solver.open([[0, 1], [1, 2]], 4, device="cpu")
    out = repro_torch.Solver.solve_batch([s.graph()])
    np.testing.assert_array_equal(out[0].labels.numpy(), [0, 0, 0, 3])
    want = repro.Solver.solve_batch([(np.asarray([[0, 1], [1, 2]]), 4)])
    assert _ints(out[0].work) == _ints(want[0].work)
    j = repro.Solver.open([[0, 1], [1, 2]], 4)
    with pytest.raises(ValueError) as jerr:
        j.solve(backend="batched")
    with pytest.raises(ValueError) as terr:
        s.solve(backend="batched")
    assert str(terr.value) == str(jerr.value)


def test_open_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Solver.open([[0, 1]], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Solver.open(None, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve([[0, 1]], 2)
