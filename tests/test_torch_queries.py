"""repro_torch's connectivity queries against repro.connectivity.queries:
every query on the corpus's labels and on seeded random labellings
(non-canonical ones for ``count_components``), out-of-range ids (the
reference clamps them through its gathers), a histogram with a component
of 2^25 - 1 vertices, and ``spanning_forest_stats`` on a good forest and
on broken ones. Integer answers: the tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.connectivity import queries as jq
from repro.core import cc as jcc
from repro_torch.connectivity import queries as tq

CASES = [c for c in corpus() if c[1] > 0]
IDS = [c[0] for c in CASES]


def _labellings():
    """(name, labels) pairs: the corpus's canonical labels, then seeded
    random labellings with values in [0, V) (not canonical: any label
    may stand for a component)."""
    out = [(name, np.asarray(jcc.solve_static(e, n, "adaptive").labels))
           for name, n, e in CASES]
    rng = np.random.default_rng(17)
    for i, (n, k) in enumerate([(1, 1), (9, 3), (64, 64), (100, 7),
                                (257, 40), (1000, 1)]):
        out.append((f"random-{i}", rng.integers(0, k, n).astype(np.int32)))
    return out


LABELS = _labellings()
LIDS = [name for name, _ in LABELS]


def _pair(labels):
    return torch.from_numpy(labels.copy()), jnp.asarray(labels)


@pytest.mark.parametrize("name,labels", LABELS, ids=LIDS)
def test_label_queries_match_reference(name, labels):
    t, j = _pair(labels)
    n = labels.shape[0]
    rng = np.random.default_rng(n)
    pairs = rng.integers(0, n, (33, 2)).astype(np.int32)
    vertices = rng.integers(0, n, 21).astype(np.int32)
    np.testing.assert_array_equal(tq.same_component(t, pairs).numpy(),
                                  np.asarray(jq.same_component(j, pairs)))
    for got, want in ((tq.component_census(t), jq.component_census(j)),
                      (tq.component_sizes(t), jq.component_sizes(j)),
                      (tq.component_size(t, vertices),
                       jq.component_size(j, vertices)),
                      (tq.component_histogram(t),
                       jq.component_histogram(j))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    count = tq.count_components(t)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(jq.count_components(j)) == len(np.unique(labels))


def test_count_components_of_empty_labels():
    got = tq.count_components(torch.zeros(0, dtype=torch.int32))
    assert int(got) == int(jq.count_components(jnp.zeros(0, jnp.int32))) == 0
    np.testing.assert_array_equal(
        tq.component_histogram(torch.zeros(0, dtype=torch.int32)).numpy(),
        np.asarray(jq.component_histogram(jnp.zeros(0, jnp.int32))))


def test_out_of_range_ids_are_clamped_as_the_reference_does():
    labels = np.array([0, 0, 2, 3, 2, 5, 5, 5], np.int32)
    t, j = _pair(labels)
    pairs = np.array([[-1, 7], [-8, 0], [-9, 1], [8, 5], [100, -100],
                      [3, 2**30], [-3, 6]], np.int32)
    vertices = np.array([-1, -8, -20, 8, 2**31 - 1, 3], np.int32)
    np.testing.assert_array_equal(tq.same_component(t, pairs).numpy(),
                                  np.asarray(jq.same_component(j, pairs)))
    np.testing.assert_array_equal(
        tq.component_size(t, vertices).numpy(),
        np.asarray(jq.component_size(j, vertices)))


def test_floor_log2_is_exact_above_2_24():
    vals = np.array([1, 2, 3, 2**16 - 1, 2**16, 2**16 + 1, 2**24 - 1, 2**24,
                     2**24 + 1, 2**25 - 1, 2**25, 2**30 + 7, 2**31 - 1],
                    np.int32)
    got = tq._floor_log2(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq._floor_log2(
        jnp.asarray(vals))))
    np.testing.assert_array_equal(got, np.floor(np.log2(
        vals.astype(np.float64))).astype(np.int64))


def test_histogram_with_a_component_of_2_25_minus_1():
    """One component of 2^25 - 1 vertices: float32 would round the size
    up to 2^25 and bin it at 25; the exact log2 bins it at 24."""
    n = 2**25 - 1
    labels = np.zeros(n, np.int32)
    got = tq.component_histogram(torch.from_numpy(labels)).numpy()
    want = np.asarray(jq.component_histogram(jnp.asarray(labels)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (26,) and got[24] == 1 and got.sum() == 1


def _forest_case():
    n = 9
    edges = np.array([[0, 1], [1, 2], [3, 4], [5, 6], [6, 7], [7, 5],
                      [2, 0]], np.int32)
    res = jcc.solve_forest(edges, n, "adaptive")
    return np.asarray(res.labels), np.asarray(res.parents)


def _broken_forests(labels, parents):
    """A cross-component edge, a dropped edge, and an extra row."""
    rec = np.flatnonzero(parents[:, 0] >= 0)
    cross = parents.copy()
    cross[rec[0]] = [0, 3]
    dropped = parents.copy()
    dropped[rec[0]] = [-1, -1]
    extra = parents.copy()
    extra[8] = [8, 8]
    return {"cross": cross, "dropped": dropped, "extra": extra}


def test_spanning_forest_stats_match_reference():
    labels, parents = _forest_case()
    cases = {"good": parents, **_broken_forests(labels, parents)}
    for name, par in cases.items():
        got = tq.spanning_forest_stats(torch.from_numpy(labels),
                                       torch.from_numpy(par))
        want = jq.spanning_forest_stats(jnp.asarray(labels),
                                        jnp.asarray(par))
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}, name
        ok = bool(got["edges_intra_component"]) and \
            bool(got["count_consistent"])
        assert ok == (name == "good"), name
    empty = tq.spanning_forest_stats(torch.zeros(0, dtype=torch.int32),
                                     torch.zeros((0, 2), dtype=torch.int32))
    want = jq.spanning_forest_stats(jnp.zeros(0, jnp.int32),
                                    jnp.zeros((0, 2), jnp.int32))
    assert {k: int(v) for k, v in empty.items()} == \
        {k: int(v) for k, v in want.items()}


def test_to_host():
    t = torch.arange(4, dtype=torch.int32)
    out = tq.to_host(t)
    assert isinstance(out, np.ndarray) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.arange(4))
