"""repro_torch's EdgeLog substrate against repro.graphs.device: the
undirected group ids (one case at |V| > 46,341, where a ``min * |V| +
max`` int32 key would overflow), the tombstone matching, the alive-row
compaction with its permutation, and EdgeLog scripts (append with the
pow2 headroom rule, grow, delete, view, compact) with the edges, the
alive mask, the cursor and the capacity equal after every step; plus
the numpy ``DynamicConnectivityOracle``. Integer state: the tolerance
is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unionfind as juf
from repro.graphs import device as jdev
from repro_torch.core import unionfind as tuf
from repro_torch.graphs import device as tdev


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("n,rows,seed", [(9, 40, 0), (50, 300, 1),
                                         (200_000, 4000, 2)])
def test_undirected_group_ids_match_reference(n, rows, seed):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, (rows, 2)).astype(np.int32)
    # duplicates and reversed copies share ids; the largest ids land high
    pairs[rows // 2:rows // 2 + 20] = pairs[:20, ::-1]
    pairs[-1] = [n - 1, n - 2]
    want = np.asarray(jdev.undirected_group_ids(jnp.asarray(pairs)))
    got = tdev.undirected_group_ids(_t(pairs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_tombstone_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, e, d = 30, 64, 16
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    alive = rng.random(e) < 0.8
    dels = np.concatenate([edges[rng.integers(0, e, 8)][:, ::-1],
                           rng.integers(0, n, (8, 2))]).astype(np.int32)
    d_true = int(rng.integers(0, d + 1))
    want = jdev.tombstone_mask(jnp.asarray(edges), jnp.asarray(alive),
                               jnp.asarray(dels), jnp.int32(d_true))
    for dt in (d_true, torch.tensor(d_true, dtype=torch.int32)):
        got = tdev.tombstone_mask(_t(edges), torch.from_numpy(alive),
                                  _t(dels), dt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tombstone_mask_edge_cases():
    edges = _t([[0, 1], [1, 0], [2, 2], [0, 0]])
    alive = torch.tensor([True, True, True, False])
    # an empty batch and an all-padding batch kill nothing
    for dels, dt in ((_t(np.zeros((0, 2))), 0), (_t([[0, 1]]), 0)):
        new, killed = tdev.tombstone_mask(edges, alive, dels, dt)
        assert torch.equal(new, alive) and not killed.any()
    # (0, 0) deletes only alive (0, 0) copies; both orientations die
    new, killed = tdev.tombstone_mask(edges, alive, _t([[1, 0], [0, 0]]), 2)
    assert killed.tolist() == [True, True, False, False]
    assert new.tolist() == [False, False, True, False]


@pytest.mark.parametrize("seed", range(3))
def test_compact_alive_perm_matches_reference(seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, 20, (32, 2)).astype(np.int32)
    alive = rng.random(32) < 0.5
    want = jdev.compact_alive_perm(jnp.asarray(edges), jnp.asarray(alive))
    got = tdev.compact_alive_perm(_t(edges), torch.from_numpy(alive))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    packed, true = tdev.compact_alive(_t(edges), torch.from_numpy(alive))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[0]))
    assert int(true) == int(want[1])


def _assert_log_equal(t: tdev.EdgeLog, j: jdev.EdgeLog):
    assert (t.capacity, t.rows) == (j.capacity, j.rows)
    np.testing.assert_array_equal(t.edges.numpy(), np.asarray(j.edges))
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    assert t.num_alive == j.num_alive
    assert int(t.num_alive_device()) == int(j.num_alive_device())


@pytest.mark.parametrize("seed", range(4))
def test_edgelog_script_matches_reference(seed):
    """Appends of ragged sizes (the pow2 block and its headroom grow the
    capacity), deletes with duplicates and reversed rows, views and
    compactions: the whole log equal after every step."""
    rng = np.random.default_rng(seed)
    n = 40
    t, j = tdev.EdgeLog(n, device="cpu"), jdev.EdgeLog(n)
    _assert_log_equal(t, j)
    for step in range(14):
        e = rng.integers(0, n, (int(rng.integers(0, 70)), 2)).astype(np.int32)
        t.append(tdev.DeviceGraph.from_edges(e, n, device="cpu"))
        j.append(jdev.DeviceGraph.from_edges(e, n))
        _assert_log_equal(t, j)
        if j.rows:
            live = np.asarray(j.edges)[np.asarray(j.alive)]
            dels = np.concatenate(
                [live[rng.integers(0, max(len(live), 1), 5)][:, ::-1]
                 if len(live) else np.zeros((0, 2), np.int32),
                 rng.integers(0, n, (3, 2))]).astype(np.int32)
            kt = t.delete(_t(dels), dels.shape[0])
            kj = j.delete(jnp.asarray(dels), dels.shape[0])
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            _assert_log_equal(t, j)
        vt, vj = t.view(), j.view()
        assert vt.true_edges == int(vj.true_edges)
        assert vars(vt.plan) == vars(vj.plan)
        assert vt.count_on_device and vt.name == vj.name
        np.testing.assert_array_equal(vt.edges.numpy(), np.asarray(vj.edges))
        if step % 5 == 4:
            np.testing.assert_array_equal(t.compact().numpy(),
                                          np.asarray(j.compact()))
            _assert_log_equal(t, j)
    assert repr(t) == repr(j)


def test_edgelog_rejects_mismatch_and_static_graph_count():
    log = tdev.EdgeLog(5, device="cpu")
    with pytest.raises(ValueError, match="num_nodes"):
        log.append(tdev.DeviceGraph.from_edges([[0, 1]], 6, device="cpu"))
    g = tdev.DeviceGraph.from_edges([[0, 1], [1, 2]], 5, device="cpu")
    t = g.true_edges_device()
    assert t.dtype == torch.int32 and int(t) == 2 and t.device == g.device
    assert not g.is_empty and not g.count_on_device
    assert tdev.DeviceGraph.from_edges(np.zeros((0, 2)), 5,
                                       device="cpu").is_empty
    # a reversed (negatively strided) host array is ingested as is
    arr = np.array([[0, 1], [2, 3]], np.int32)[:, ::-1]
    np.testing.assert_array_equal(
        tdev.DeviceGraph.from_edges(arr, 5, device="cpu").edges.numpy(),
        [[1, 0], [3, 2]])


def test_dynamic_oracle_matches_reference():
    rng = np.random.default_rng(5)
    n = 25
    t, j = tuf.DynamicConnectivityOracle(n), juf.DynamicConnectivityOracle(n)
    for step in range(40):
        e = rng.integers(0, n, (int(rng.integers(0, 12)), 2))
        t.insert(e)
        j.insert(e)
        live = t.alive()
        kill = live[rng.integers(0, len(live), 4)][:, ::-1] \
            if len(live) and step % 2 else rng.integers(0, n, (3, 2))
        t.delete(kill)
        j.delete(kill)
        np.testing.assert_array_equal(t.alive(), j.alive())
        assert t.alive().dtype == j.alive().dtype
    np.testing.assert_array_equal(t.labels(), j.labels())
