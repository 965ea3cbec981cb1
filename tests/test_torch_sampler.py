"""repro_torch's neighbour sampler and edge partitioner against the
reference's, on the CPU. Both are host numpy making the same
``np.random.Generator`` calls in the same order, so every array is
equal exactly (tolerance 0) for the same seed and graph.
"""
import numpy as np
import pytest

from repro.graphs import format as jfmt
from repro.graphs import generators as jgen
from repro.graphs import partition as jpart
from repro.graphs import sampler as jsamp
from repro_torch.graphs import format as tfmt
from repro_torch.graphs import partition as tpart
from repro_torch.graphs import sampler as tsamp


def _csrs(scale: int, edge_factor: int, seed: int, isolated: int = 0):
    """The same R-MAT graph's CSR in both packages, with ``isolated``
    extra vertices that have no edge (the sampler's self-edge case)."""
    g = jgen.rmat(scale, edge_factor, seed=seed)
    n = g.num_nodes + isolated
    return (jfmt.build_csr(g.edges, n), tfmt.build_csr(g.edges, n), n)


def _same_minibatch(a, b):
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        for f in ("src", "dst", "dst_nodes"):
            got, want = getattr(y, f), getattr(x, f)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b.input_nodes, a.input_nodes)
    np.testing.assert_array_equal(b.seed_nodes, a.seed_nodes)


@pytest.mark.parametrize("fanouts", ((15, 10), (25, 10), (3,)))
def test_sample_minibatch_equals_reference(fanouts):
    jcsr, tcsr, n = _csrs(8, 8, 0, isolated=5)
    seeds = np.concatenate([np.arange(0, 64, 2), [n - 1, n - 3]])
    a = jsamp.sample_minibatch(jcsr, seeds, fanouts,
                               np.random.default_rng(5))
    b = tsamp.sample_minibatch(tcsr, seeds, fanouts,
                               np.random.default_rng(5))
    _same_minibatch(a, b)
    # isolated seeds sample themselves
    last = b.blocks[-1]
    assert np.all(last.src[-fanouts[-1]:] == n - 3)


def test_minibatch_loader_epochs_equal_reference():
    jcsr, tcsr, _ = _csrs(7, 4, 1)
    args = dict(train_nodes=np.arange(70), batch_size=16, fanouts=[5, 5],
                seed=3)
    ja, ta = jsamp.MiniBatchLoader(jcsr, **args), \
        tsamp.MiniBatchLoader(tcsr, **args)
    for epoch in (0, 1):
        got, want = list(ta.epoch(epoch)), list(ja.epoch(epoch))
        assert len(got) == len(want) == 4          # the last 6 dropped
        for a, b in zip(want, got):
            _same_minibatch(a, b)
    assert not np.array_equal(list(ta.epoch(0))[0].seed_nodes,
                              list(ta.epoch(1))[0].seed_nodes)


@pytest.mark.parametrize("mode", ("block", "hash"))
@pytest.mark.parametrize("parts", (1, 3, 4, 7))
def test_partition_edges_and_boundary_equal_reference(mode, parts):
    g = jgen.rmat(7, 6, seed=2)
    jg = jfmt.Graph(edges=g.edges, num_nodes=g.num_nodes)
    tg = tfmt.Graph(edges=g.edges.copy(), num_nodes=g.num_nodes)
    want = jpart.partition_edges(jg, parts, mode)
    got = tpart.partition_edges(tg, parts, mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpart.boundary_vertices(got),
                                  jpart.boundary_vertices(want))


def test_partition_refuses_an_unknown_mode():
    g = tfmt.Graph(edges=np.zeros((4, 2), np.int32), num_nodes=2)
    with pytest.raises(ValueError, match="unknown partition mode"):
        tpart.partition_edges(g, 2, "metis")
