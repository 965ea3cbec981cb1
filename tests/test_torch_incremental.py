"""repro_torch's IncrementalCC against repro.core.incremental: seeded
insert scripts (host arrays and DeviceGraphs, with self loops,
duplicates and already-connected batches) with labels, the version and
all five WorkCounters equal after every batch; ``adopt``, the lazy work
drain, the on-device metrics (``repro_torch.obs.metrics`` against
``repro.obs.metrics``), and the ``incremental`` / ``dynamic`` backends
through the registry. Integer work: the tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import incremental as jinc
from repro.core.rounds import WorkCounters as JW
from repro.graphs.device import DeviceGraph as JG
from repro.obs import metrics as jmetrics
from repro_torch.core import incremental as tinc
from repro_torch.core.rounds import WorkCounters as TW
from repro_torch.graphs.device import DeviceGraph as TG
from repro_torch.obs import metrics as tmetrics


def _assert_state(t, j):
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert t.labels.dtype == torch.int32
    assert t.version == j.version
    assert int(t.version_device) == int(j.version_device)
    assert t.work == j.work
    assert (t.num_edges_inserted, t.batches_absorbed) == \
        (j.num_edges_inserted, j.batches_absorbed)


@pytest.mark.parametrize("seed", range(4))
def test_insert_script_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 70
    t = tinc.IncrementalCC(n, device="cpu")
    j = jinc.IncrementalCC(n)
    t.enable_metrics()
    j.enable_metrics()
    for step in range(16):
        k = int(rng.integers(0, 40))
        e = rng.integers(0, n, (k, 2)).astype(np.int32)
        if step % 4 == 1 and k:
            e[: k // 2] = e[: k // 2, ::-1]          # duplicates, reversed
            e[-1] = [e[-1, 0], e[-1, 0]]            # a self loop
        if step % 3 == 2:
            t.insert_graph(TG.from_edges(e, n, device="cpu"))
            j.insert_graph(JG.from_edges(e, n))
        else:
            t.insert(e)
            j.insert(e)
        _assert_state(t, j)
    # an already-connected batch costs zero hook rounds and no tick
    before, v = t.work, t.version
    lab = t.labels.numpy()
    same = np.stack([np.arange(n), lab], 1).astype(np.int32)
    t.insert(same)
    j.insert(same)
    _assert_state(t, j)
    assert t.work["hook_rounds"] == before["hook_rounds"] and t.version == v
    assert tmetrics.flush(t.metrics) == jmetrics.flush(j.metrics)
    for u, w in ((0, 1), (3, n - 1), (5, 5)):
        assert t.connected(u, w) == j.connected(u, w)
    assert t.num_components() == j.num_components()
    with pytest.raises(ValueError, match="out of range"):
        t.connected(0, n)
    with pytest.raises(ValueError, match="out of range"):
        t.insert([[0, n]])


def test_adopt_and_drain_match_reference(monkeypatch):
    """``adopt`` bills the given work and ticks only on a change; the
    per-batch counters drain into host ints every _DRAIN_EVERY
    batches."""
    monkeypatch.setattr(tinc, "_DRAIN_EVERY", 3)
    n = 12
    t, j = tinc.IncrementalCC(n, device="cpu"), jinc.IncrementalCC(n)
    t.enable_metrics()
    j.enable_metrics()
    labels = np.minimum(np.arange(n), 4).astype(np.int32)
    work = {"hook_ops": 7, "jump_ops": 3, "jump_sweeps": 1,
            "hook_rounds": 1, "sync_rounds": 1}
    t.adopt(labels, work=TW.zeros("cpu").add(**work), num_edges=5)
    j.adopt(labels, work=JW.zeros().add(**work), num_edges=5)
    _assert_state(t, j)
    t.adopt(labels, work=work)                     # unchanged: no tick
    j.adopt(labels, work=work)
    _assert_state(t, j)
    for i in range(7):
        t.insert([[i, i + 5]])
        j.insert([[i, i + 5]])
        assert len(t._work_pending) < 3
    _assert_state(t, j)
    assert tmetrics.flush(t.metrics) == jmetrics.flush(j.metrics)
    with pytest.raises(ValueError, match="labels shape"):
        t.adopt(np.zeros(n + 1, np.int32))
    with pytest.raises(ValueError, match="num_nodes"):
        t.insert_graph(TG.from_edges([[0, 1]], n + 1, device="cpu"))
    with pytest.raises(ValueError, match="num_nodes must be"):
        tinc.IncrementalCC(-1, device="cpu")


def test_empty_graph_and_empty_batches():
    t, j = tinc.IncrementalCC(0, device="cpu"), jinc.IncrementalCC(0)
    t.insert(np.zeros((0, 2), np.int32))
    j.insert(np.zeros((0, 2), np.int32))
    _assert_state(t, j)
    t, j = tinc.IncrementalCC(4, device="cpu"), jinc.IncrementalCC(4)
    t.insert([])
    j.insert([])
    _assert_state(t, j)


@pytest.mark.parametrize("kind", ("insert", "delete"))
@pytest.mark.parametrize("seed", range(3))
def test_metrics_record_matches_reference(kind, seed):
    rng = np.random.default_rng(seed)
    t, j = tmetrics.Metrics.zeros("cpu"), jmetrics.Metrics.zeros()
    for _ in range(6):
        c = int(rng.integers(0, 1 << int(rng.integers(1, 30))))
        h = int(rng.integers(0, 1 << 30))
        v0 = int(rng.integers(0, 3))
        v1 = v0 + int(rng.integers(0, 2))
        t = tmetrics.record_mutation(
            t, TW.zeros("cpu").add(hook_ops=h, jump_sweeps=2),
            torch.tensor(c, dtype=torch.int32), torch.tensor(v0),
            torch.tensor(v1), kind=kind)
        j = jmetrics.record_mutation(
            j, JW.zeros().add(hook_ops=h, jump_sweeps=2), jnp.int32(c),
            jnp.int32(v0), jnp.int32(v1), kind=kind)
    t, j = tmetrics.record_rebuild(t), jmetrics.record_rebuild(j)
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
    assert tmetrics.flush(t) == jmetrics.flush(j)
    merged = t.merge(t)
    np.testing.assert_array_equal(merged.counts.numpy(),
                                  2 * t.counts.numpy())
    with pytest.raises(ValueError, match="insert|delete"):
        tmetrics.record_mutation(t, TW.zeros("cpu"), 1, 0, 0, kind="x")


def test_histogram_spec_matches_reference():
    t, j = tmetrics.WORK_SPEC, jmetrics.WORK_SPEC
    np.testing.assert_array_equal(t.edges, j.edges)
    assert t.resolution() == j.resolution()
    vals = np.array([0.5, 1, 3, 1e5, 2.0**31])
    np.testing.assert_array_equal(t.bucket(vals), j.bucket(vals))
    np.testing.assert_array_equal(
        t.bucket_device(torch.tensor(vals)).numpy(),
        [int(j.bucket_device(jnp.float32(v))) for v in vals])
    counts = np.zeros(t.num_bins, np.int64)
    for v in vals:
        t.observe(counts, v)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert t.quantile(counts, q) == j.quantile(counts, q)
    assert (tmetrics.COUNTERS, tmetrics.HIST_KINDS) == \
        (jmetrics.COUNTERS, jmetrics.HIST_KINDS)
    with pytest.raises(ValueError):
        tmetrics.HistogramSpec(2.0, 1.0, 8)


@pytest.mark.parametrize("backend", ("incremental", "dynamic"))
def test_streaming_backends_run_like_reference(backend):
    rng = np.random.default_rng(11)
    n = 50
    edges = rng.integers(0, n, (90, 2)).astype(np.int32)
    j = repro.Solver.open(edges, n).solve(backend=backend)
    t = repro_torch.Solver.open(edges, n, device="cpu").solve(
        backend=backend)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert t.work.as_ints() == {k: int(v) for k, v in
                                j.work._asdict().items()}
    state = repro_torch.get_backend(backend).make_state(n, device="cpu")
    want = jinc.DynamicCC if backend == "dynamic" else jinc.IncrementalCC
    got = tinc.DynamicCC if backend == "dynamic" else tinc.IncrementalCC
    assert type(state) is got and want.__name__ == got.__name__
