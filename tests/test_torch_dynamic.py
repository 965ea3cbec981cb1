"""repro_torch's DynamicCC and its rounds against repro.core.incremental
and repro.core.rounds: seeded insert / delete scripts on both scoped
scans (torch ops, and the fused kernel's plain version against the
reference's Pallas kernel in interpret mode) and on the tree-aware
delete, with labels, the version, all five WorkCounters, ``parents``,
``parent_eidx``, the EdgeLog (edges, alive mask, cursor, capacity) and
the route counts equal after every batch; duplicates and reversed
deletes, absent edges, an empty log, a bridge against a non-bridge,
``compact`` with a valid forest, ``adopt`` then the forest rebuild; and
the id-recording and scoped rounds one call at a time. Integer work:
the tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import incremental as jinc
from repro.core import rounds as jr
from repro.core.segmentation import plan_segmentation as jplan
from repro.graphs.device import DeviceGraph as JG
from repro.obs import metrics as jmetrics
from repro_torch.core import incremental as tinc
from repro_torch.core import rounds as tr
from repro_torch.core.segmentation import plan_segmentation as tplan
from repro_torch.graphs.device import DeviceGraph as TG
from repro_torch.obs import metrics as tmetrics


def _t(a, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype))


def _ints(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


def _assert_state(t: tinc.DynamicCC, j: jinc.DynamicCC, where=""):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels),
                                  err_msg=where)
    assert t.version == j.version, where
    assert t.work == j.work, where
    assert t.forest_valid == j.forest_valid, where
    for g, w in zip(t.forest, j.forest):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=where)
    assert (t.log.capacity, t.log.rows) == (j.log.capacity, j.log.rows)
    np.testing.assert_array_equal(t.log.edges.numpy(),
                                  np.asarray(j.log.edges))
    np.testing.assert_array_equal(t.log.alive.numpy(),
                                  np.asarray(j.log.alive))
    assert t.num_edges_deleted == j.num_edges_deleted
    assert t.num_edges_alive == j.num_edges_alive
    assert t.delete_batches == j.delete_batches
    assert t.delete_route_counts(flush_obs=False) == \
        j.delete_route_counts(flush_obs=False)


def _pair(n, scan="jnp"):
    t = tinc.DynamicCC(n, scan_method=scan, device="cpu")
    j = jinc.DynamicCC(n, scan_method=scan)
    t.enable_metrics()
    j.enable_metrics()
    return t, j


def _delete(t, j, dels, forest: bool):
    dels = np.asarray(dels, np.int32).reshape(-1, 2)
    if forest:
        t.delete_graph_forest(TG.from_edges(dels, t.num_nodes, device="cpu"))
        j.delete_graph_forest(JG.from_edges(dels, j.num_nodes))
    else:
        t.delete(dels)
        j.delete(dels)


@pytest.mark.parametrize("scan", ("jnp", "pallas_fused"))
@pytest.mark.parametrize("seed", range(2))
def test_scoped_delete_script_matches_reference(seed, scan):
    rng = np.random.default_rng(seed)
    n = 48
    t, j = _pair(n, scan)
    for step in range(10):
        e = rng.integers(0, n, (int(rng.integers(1, 30)), 2))
        if step % 3 == 0:
            e = np.concatenate([e, e[:4]])           # duplicate rows
        t.insert(e)
        j.insert(e)
        _assert_state(t, j, f"insert {step}")
        live = np.asarray(j.log.edges)[np.asarray(j.log.alive)]
        dels = np.concatenate([live[rng.integers(0, len(live), 3)][:, ::-1],
                               rng.integers(0, n, (2, 2))])
        _delete(t, j, dels, forest=False)
        _assert_state(t, j, f"delete {step}")
    assert tmetrics.flush(t.metrics) == jmetrics.flush(j.metrics)


@pytest.mark.parametrize("seed", range(3))
def test_forest_delete_script_matches_reference(seed):
    """Tree-aware deletes, interleaved with scoped ones, a bulk
    tombstone and an adopt (each stales the forest, so the next forest
    delete rebuilds it), and compactions with a valid forest."""
    rng = np.random.default_rng(10 + seed)
    n = 40
    t, j = _pair(n)
    for step in range(12):
        e = rng.integers(0, n, (int(rng.integers(1, 25)), 2))
        t.insert(e)
        j.insert(e)
        live = np.asarray(j.log.edges)[np.asarray(j.log.alive)]
        dels = live[rng.integers(0, len(live), int(rng.integers(1, 5)))]
        if step % 2:
            dels = dels[:, ::-1]
        if step % 4 == 3:
            _delete(t, j, dels, forest=False)       # stales the forest
        elif step == 5:
            t.tombstone_graph(TG.from_edges(dels, n, device="cpu"))
            j.tombstone_graph(JG.from_edges(dels.astype(np.int32), n))
        else:
            _delete(t, j, dels, forest=True)
        _assert_state(t, j, f"step {step}")
        if step in (6, 9):
            t.ensure_forest()
            j.ensure_forest()
            t.compact()
            j.compact()
            _assert_state(t, j, f"compact {step}")
    assert tmetrics.flush(t.metrics) == jmetrics.flush(j.metrics)


def test_bridge_ticks_and_non_bridge_does_not():
    for forest in (False, True):
        t, j = _pair(6)
        # a triangle 0-1-2 with a tail 2-3 (a bridge)
        for s in (t, j):
            s.insert([[0, 1], [1, 2], [2, 0], [2, 3]])
        v = t.version
        _delete(t, j, [[1, 0]], forest)              # non-bridge
        _assert_state(t, j)
        assert t.version == v and t.connected(0, 1)
        _delete(t, j, [[3, 2]], forest)              # bridge: a split
        _assert_state(t, j)
        assert t.version == v + 1 and not t.connected(2, 3)


@pytest.mark.parametrize("forest", (False, True))
def test_absent_and_empty_deletes_bill_nothing(forest):
    t, j = _pair(8)
    _delete(t, j, [[0, 1]], forest)                  # empty log
    _assert_state(t, j)
    assert t.delete_batches == 1 and t.work["sync_rounds"] == 0
    for s in (t, j):
        s.insert([[0, 1], [2, 3], [2, 3]])
    before = t.work
    _delete(t, j, [[4, 5], [1, 2]], forest)          # absent edges
    _assert_state(t, j)
    assert t.work["hook_ops"] == before["hook_ops"]
    _delete(t, j, np.zeros((0, 2)), forest)          # empty batch
    _delete(t, j, [[3, 2]], forest)                  # both copies die
    _assert_state(t, j)
    assert t.num_edges_deleted == 2
    _delete(t, j, [[3, 2]], forest)                  # a double delete
    _assert_state(t, j)


def test_adopt_stage_and_rebuild_match_reference():
    rng = np.random.default_rng(4)
    n = 30
    t, j = _pair(n)
    e = rng.integers(0, n, (40, 2)).astype(np.int32)
    t.stage(TG.from_edges(e, n, device="cpu"))
    j.stage(JG.from_edges(e, n))
    gt, gj = t.graph(), j.graph()
    np.testing.assert_array_equal(gt.edges.numpy(), np.asarray(gj.edges))
    from repro.core import cc as jcc
    from repro_torch.core import cc as tcc
    rt = tcc.solve_static(gt, method="adaptive")
    rj = jcc.solve_static(gj, method="adaptive")
    assert rt.work.as_ints() == _ints(rj.work)
    t.adopt(rt.labels, work=rt.work, num_edges=40)
    j.adopt(rj.labels, work=rj.work, num_edges=40)
    _assert_state(t, j)
    assert not t.forest_valid
    t.ensure_forest()
    j.ensure_forest()
    _assert_state(t, j)
    assert t.forest_rebuilds == j.forest_rebuilds == 1
    _delete(t, j, e[:3], forest=True)
    _assert_state(t, j)
    with pytest.raises(ValueError, match="scan_method"):
        tinc.DynamicCC(4, scan_method="pallas", device="cpu")
    with pytest.raises(ValueError, match="num_nodes"):
        t.delete_graph(TG.from_edges([[0, 1]], n + 1, device="cpu"))


def test_rebuild_over_an_emptied_log_bills_as_reference():
    """A rebuild over a view with no alive rows still runs (and bills
    its fixed rounds), as the reference's device-held count does."""
    from repro.core import cc as jcc
    from repro_torch.core import cc as tcc
    t, j = _pair(10)
    for s in (t, j):
        s.insert([[0, 1], [1, 2]])
    for s in (t, j):
        s.tombstone_graph(
            (TG.from_edges([[0, 1], [2, 1]], 10, device="cpu")
             if s is t else JG.from_edges(np.array([[0, 1], [2, 1]]), 10)))
    for method in ("adaptive", "atomic_hook", "labelprop"):
        rt = tcc.solve_static(t.graph(), method=method)
        rj = jcc.solve_static(j.graph(), method=method)
        np.testing.assert_array_equal(rt.labels.numpy(),
                                      np.asarray(rj.labels))
        assert rt.work.as_ints() == _ints(rj.work), method


# -- the rounds, one call at a time -------------------------------------------

def _compressed_pi(rng, n):
    """Canonical labels of a few random merges (a compressed π)."""
    pi = np.arange(n)
    for _ in range(n // 3):
        a, b = rng.integers(0, n, 2)
        lo, hi = sorted((pi[a], pi[b]))
        pi[pi == hi] = lo
    return pi


@pytest.mark.parametrize("lift", (0, 2))
@pytest.mark.parametrize("seed", range(3))
def test_hook_edges_forest_ids_matches_reference(seed, lift):
    rng = np.random.default_rng(seed)
    n = 30
    pi = _compressed_pi(rng, n).astype(np.int32)
    edges = rng.integers(0, n, (50, 2)).astype(np.int32)
    edges[10:20] = edges[:10]                          # slot tie-breaks
    ids = rng.permutation(100)[:50].astype(np.int32)
    parents = np.full((n, 2), -1, np.int32)
    eidx = np.full(n, -1, np.int32)
    want = jr.hook_edges_forest_ids(jnp.asarray(pi), jnp.asarray(parents),
                                    jnp.asarray(eidx), jnp.asarray(edges),
                                    jnp.asarray(ids), lift_steps=lift)
    got = tr.hook_edges_forest_ids(_t(pi), _t(parents), _t(eidx), _t(edges),
                                   _t(ids), lift_steps=lift)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(tr.empty_forest_idx(n).numpy(),
                          np.asarray(jr.empty_forest_idx(n)))


@pytest.mark.parametrize("seed", range(3))
def test_forest_scoped_rounds_match_reference(seed):
    """The tree-aware reconnection on a maintained forest, with the
    crossing rows masked in place (not a prefix)."""
    rng = np.random.default_rng(20 + seed)
    n = 36
    j = jinc.DynamicCC(n)
    j.insert(rng.integers(0, n, (70, 2)))
    edges, alive = np.asarray(j.log.edges), np.asarray(j.log.alive)
    pi = np.asarray(j.labels)
    parents, eidx = map(np.asarray, j.forest)
    killed = np.zeros_like(alive)
    killed[rng.integers(0, j.log.rows, 8)] = True
    killed &= alive
    alive2 = alive & ~killed
    has = eidx >= 0
    hit = has & killed[np.maximum(eidx, 0)]
    aff = np.zeros(n, bool)
    aff[pi[hit]] = True
    in_aff = aff[pi]
    edge_aff = alive2 & in_aff[edges[:, 0]]
    keep = in_aff & has & ~killed[np.maximum(eidx, 0)]
    ids = np.arange(edges.shape[0], dtype=np.int32)
    want = jr.forest_scoped_rounds(
        *map(jnp.asarray, (pi, parents, eidx, edges, ids, edge_aff, keep,
                           in_aff)), jr.WorkCounters.zeros())
    got = tr.forest_scoped_rounds(
        _t(pi), _t(parents), _t(eidx), _t(edges), _t(ids),
        torch.from_numpy(edge_aff), torch.from_numpy(keep),
        torch.from_numpy(in_aff), tr.WorkCounters.zeros("cpu"))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].as_ints() == _ints(want[3])


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("seed", range(3))
def test_scoped_rounds_match_reference(seed, fused):
    rng = np.random.default_rng(30 + seed)
    n, cap = 40, 128
    edges = np.zeros((cap, 2), np.int32)
    edges[:90] = rng.integers(0, n, (90, 2))
    mask = np.zeros(cap, bool)
    mask[:90] = rng.random(90) < 0.7
    pi = np.asarray(jr.cleanup_rounds(
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(edges[:90]),
        jr.jnp_round_ops(2), jr.WorkCounters.zeros())[0])
    vmask = np.isin(pi, pi[edges[mask][:, 0]])
    edge_mask = mask & vmask[edges[:, 0]]
    bill = int(vmask.sum())
    tp, jp = tplan(cap, n, 4), jplan(cap, n, 4)
    jops = jr.fused_round_ops(2, bill_nodes=jnp.int32(bill)) if fused \
        else jr.jnp_round_ops(2, bill_nodes=jnp.int32(bill))
    tops = tr.fused_round_ops(2, bill_nodes=torch.tensor(bill)) if fused \
        else tr.torch_round_ops(2, bill_nodes=torch.tensor(bill))
    want = jr.scoped_rounds(jnp.asarray(pi), jnp.asarray(edges),
                            jnp.asarray(edge_mask), jnp.asarray(vmask),
                            jp, jops, jr.WorkCounters.zeros())
    got = tr.scoped_rounds(_t(pi), _t(edges), torch.from_numpy(edge_mask),
                           torch.from_numpy(vmask), tp, tops,
                           tr.WorkCounters.zeros("cpu"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].as_ints() == _ints(want[1])


def test_pack_and_scan_rounds_ids_match_reference():
    rng = np.random.default_rng(8)
    n = 50
    edges = rng.integers(0, n, (100, 2)).astype(np.int32)
    ids = np.arange(100, dtype=np.int32)
    mask = rng.random(100) < 0.6
    pj = jr.pack_edge_rows(jnp.asarray(edges), jnp.asarray(ids),
                           jnp.asarray(mask))
    pt = tr.pack_edge_rows(_t(edges), _t(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj[0]))
    np.testing.assert_array_equal(pt[1].numpy(), np.asarray(pj[1]))
    assert pt[2] == int(pj[2])
    pi0 = np.arange(n, dtype=np.int32)
    forest = np.full((n, 2), -1, np.int32)
    eidx = np.full(n, -1, np.int32)
    for seg in (16, 512):
        want = jr.forest_scan_rounds_ids(
            *map(jnp.asarray, (pi0, forest, eidx, pj[0], pj[1])), pj[2],
            jr.WorkCounters.zeros(), lift_steps=2, bill_nodes=17,
            segment_size=seg)
        got = tr.forest_scan_rounds_ids(
            _t(pi0), _t(forest), _t(eidx), pt[0], pt[1], pt[2],
            tr.WorkCounters.zeros("cpu"), lift_steps=2, bill_nodes=17,
            segment_size=seg)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3].as_ints() == _ints(want[3])
