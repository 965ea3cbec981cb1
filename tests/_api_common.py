"""Helpers shared by the front-door parity tests
(``tests/test_torch_api*.py``): the graphs (the named corpus and the
Table I stand-ins at scale 0.002), both packages' sessions on one graph,
and the plan-and-solve check that ``test_torch_api_solver*.py`` run, a
few graphs a file. Integer work: the tolerance is 0."""
import numpy as np
import pytest
import torch

import repro
from _graphgen import corpus
from repro.connectivity import policy as jpolicy
from repro.graphs.generators import table1_scaled
import repro_torch
from repro_torch.connectivity import policy as tpolicy

NOT_PORTED = set()
GRAPHS = [(name, n, e) for name, n, e in corpus()] + [
    (f"{name}@0.002", g.num_nodes, g.edges) for name, g in
    ((name, table1_scaled(name, scale=0.002, seed=1))
     for name in ("usa-osm", "euro-osm-karls", "soc-live-journal",
                  "kron-logn21"))]
GIDS = [g[0] for g in GRAPHS]
TABLE1 = GIDS[-4:]


def _ints(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


def _open(n, edges):
    """The same graph opened on each side, each with a cold cache."""
    j = repro.Solver.open(edges, n, policy_cache=jpolicy.AutotuneCache(None))
    t = repro_torch.Solver.open(edges, n, device="cpu",
                                policy_cache=tpolicy.AutotuneCache(None))
    return j, t


def solver_plans_and_solves_match_reference(name, n, edges):
    """``Solver.plan()`` chooses the same backend for the same reason,
    and ``solve()`` gives equal labels and WorkCounters on every
    registered backend; then the queries over the session's labels."""
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
