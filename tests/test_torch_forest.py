"""repro_torch's spanning-forest solves against repro.core.cc.solve_forest
over the named corpus: labels, the ``parents`` table and all five
WorkCounters array-equal for every forest method (the win rule and its
edge-index tie-break are deterministic, so nothing weaker); labels and
counters equal to the port's own ``solve_static``; and the forest valid
host-side. Integer work throughout: the tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.core import cc as jcc
from repro.core import rounds as jrounds
from repro_torch.connectivity.queries import spanning_forest_stats
from repro_torch.core import cc as tcc
from repro_torch.core import rounds as trounds

CASES = corpus()
IDS = [c[0] for c in CASES]


def assert_valid_forest(n: int, labels: np.ndarray, parents: np.ndarray):
    """Host-side proof: |V| - C recorded rows, no cycle (union-find), the
    forest's partition equals the labels', and the roots are the
    component minima."""
    valid = parents[:, 0] >= 0
    ncomp = len(np.unique(labels)) if n else 0
    assert int(valid.sum()) == n - ncomp
    pa = list(range(n))

    def find(x):
        while pa[x] != x:
            pa[x] = pa[pa[x]]
            x = pa[x]
        return x

    for u, v in parents[valid]:
        assert labels[u] == labels[v], "cross-component edge"
        ru, rv = find(int(u)), find(int(v))
        assert ru != rv, "cycle in the recorded forest"
        pa[ru] = rv
    for i in range(n):
        assert find(i) == find(int(labels[i]))
    roots = np.flatnonzero(~valid)
    np.testing.assert_array_equal(np.sort(labels[roots]), np.unique(labels))
    np.testing.assert_array_equal(labels[roots], roots)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("method", tcc.FOREST_METHODS)
def test_solve_forest_matches_reference(method, name, n, edges):
    want = jcc.solve_forest(edges, n, method)
    got = tcc.solve_forest(edges, n, method, device="cpu")
    assert got.parents.dtype == got.labels.dtype == torch.int32
    assert got.parents.shape == (n, 2)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.parents.numpy(),
                                  np.asarray(want.parents))
    assert got.work.as_ints() == {k: int(v) for k, v in
                                  want.work._asdict().items()}
    plain = tcc.solve_static(edges, n, method, device="cpu")
    assert torch.equal(plain.labels, got.labels)
    assert plain.work.as_ints() == got.work.as_ints()
    labels, parents = got.labels.numpy(), got.parents.numpy()
    assert_valid_forest(n, labels, parents)
    stats = spanning_forest_stats(got.labels, got.parents)
    assert bool(stats["edges_intra_component"])
    assert bool(stats["count_consistent"])


@pytest.mark.parametrize("lift", (0, 2))
@pytest.mark.parametrize("seed", range(4))
def test_hook_edges_forest_matches_reference(seed, lift):
    """One forest hook from a random compressed π, with duplicate edges
    (the edge-index tie-break) and self loops: π and parents equal the
    reference's."""
    rng = np.random.default_rng(seed)
    n = 40
    pi = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)
    pi = pi[pi]
    pi = pi[pi]
    pi = pi[pi].astype(np.int32)
    edges = rng.integers(0, n, (60, 2)).astype(np.int32)
    edges = np.concatenate([edges, edges[:10], edges[5:15, ::-1]])
    parents = np.full((n, 2), -1, np.int32)
    parents[:3] = [[7, 8], [9, 10], [11, 12]]
    want_pi, want_par = jrounds.hook_edges_forest(
        jnp.asarray(pi), jnp.asarray(parents), jnp.asarray(edges),
        lift_steps=lift)
    got_pi, got_par = trounds.hook_edges_forest(
        torch.from_numpy(pi), torch.from_numpy(parents),
        torch.from_numpy(edges), lift_steps=lift)
    np.testing.assert_array_equal(got_pi.numpy(), np.asarray(want_pi))
    np.testing.assert_array_equal(got_par.numpy(), np.asarray(want_par))


def test_forest_of_padded_graph_matches_reference():
    """A pow2-padded graph: billing runs on the true count, and the
    padded (0, 0) rows are never recorded."""
    from repro.graphs.device import DeviceGraph as JDeviceGraph
    from repro_torch.graphs.device import DeviceGraph
    _, n, edges = CASES[IDS.index("er-mid")]
    jg = JDeviceGraph.from_edges(edges, n).pad_pow2(min_rows=128)
    tg = DeviceGraph.from_reference(np.asarray(jg.edges), jg.num_nodes,
                                    jg.true_edges_static,
                                    jg.plan.num_segments, device="cpu")
    for method in tcc.FOREST_METHODS:
        want = jcc.solve_forest(jg, method=method)
        got = tcc.solve_forest(tg, method=method)
        np.testing.assert_array_equal(got.parents.numpy(),
                                      np.asarray(want.parents))
        assert got.work.as_ints() == {k: int(v) for k, v in
                                      want.work._asdict().items()}


def test_non_forest_methods_raise():
    _, n, edges = CASES[IDS.index("chain-17")]
    for method in ("labelprop", "pallas_fused", "sampled_fused"):
        with pytest.raises(ValueError, match="spanning forest"):
            tcc.solve_forest(edges, n, method, device="cpu")
