"""repro_torch.fleet against repro.fleet: the placement planner
(``size_plan``, ``predicted_work``, ``plan_placement``, ``imbalance``)
on the same specs; one seeded request stream (every query kind, inserts,
deletes, a sharded tenant, clamped vertex ids, a tenant dropped with
requests in flight) through both one-device ``FleetService``s, step by
step: the same requests retire in the same tick with the same results
and errors, with the same stats; one-tick-late retirement; the same
refusals; promotion, the sharded-tenant lifecycle, the exact merged SLO
and the engine over bare services as in the reference; and the
reference's 8-device fleet case and rebalance case in process, on
``devices=["cpu"] * 8``. Integer work: the tolerance is 0."""
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.connectivity import policy as jpolicy
from repro.connectivity.service import ConnectivityService as JService
from repro import fleet as jfleet
from repro_torch import obs as tobs
from repro_torch import fleet as tfleet
from repro_torch.connectivity import policy as tpolicy
from repro_torch.connectivity.service import ConnectivityService as TService
from repro_torch.core.unionfind import DynamicConnectivityOracle
from repro_torch.graphs import generators as G
from repro_torch.graphs.device import DeviceGraph
from repro_torch.obs.slo import LatencyHistogram, SLORecorder


@pytest.fixture(autouse=True)
def fresh_policy_caches(monkeypatch):
    """Both packages route on a cold autotune cache."""
    monkeypatch.setattr(jpolicy, "_default_cache", jpolicy.AutotuneCache())
    monkeypatch.setattr(tpolicy, "_default_cache", tpolicy.AutotuneCache())


def _cpu_fleet(n_dev: int = 1, **kw):
    return tfleet.FleetService(["cpu"] * n_dev, **kw)


# ---------------------------------------------------------------------------
# placement planner (host-side)
# ---------------------------------------------------------------------------

SPEC_SETS = {
    "lpt": ([(f"t{i}", 64, 64 * (i + 1), None) for i in range(8)]
            + [("whale", 1 << 16, 1 << 20, None)], 4, 1 << 18),
    "ragged": ([(f"t{i}", 32 + i, 16 * (i % 5), None) for i in range(20)],
               8, None),
    "skewed": ([("soc", 1 << 14, 1 << 18, 40.0), ("road", 1 << 14, 1 << 15,
                                                   1.2),
                ("tiny", 8, 0, None), ("kron", 1 << 12, 1 << 17, 90.0)],
               3, 1 << 17),
    "one_device": ([(f"g{i}", 100, 50 * i, None) for i in range(5)], 1,
                   None),
}


@pytest.mark.parametrize("name", sorted(SPEC_SETS))
def test_placement_matches_reference(name):
    rows, n_dev, threshold = SPEC_SETS[name]
    kw = {} if threshold is None else {"shard_threshold": threshold}
    got = tfleet.plan_placement(
        [tfleet.TenantSpec(*r) for r in rows], n_dev, **kw)
    want = jfleet.plan_placement(
        [jfleet.TenantSpec(*r) for r in rows], n_dev, **kw)
    assert (got.device_of, got.sharded, got.loads, got.work,
            got.shard_threshold) == (want.device_of, want.sharded,
                                     want.loads, want.work,
                                     want.shard_threshold)
    assert got.imbalance() == want.imbalance()
    assert got.explain() == want.explain()
    # reversed arrival: the same fixed point on both sides
    rev = tfleet.plan_placement(
        [tfleet.TenantSpec(*r) for r in reversed(rows)], n_dev, **kw)
    assert (rev.device_of, rev.loads) == (got.device_of, got.loads)
    for _, v, e, skew in rows:
        sp = tfleet.size_plan(v, e, degree_skew=skew)
        jp = jfleet.size_plan(v, e, degree_skew=skew)
        assert sp.as_dict() == jp.as_dict()
        assert tfleet.predicted_work(v, e, degree_skew=skew) == \
            jfleet.predicted_work(v, e, degree_skew=skew)


def test_placement_refusals_and_imbalance_match_reference():
    for loads in ([], [0, 0], [10, 10, 10], [30, 0, 0], [5, 7, 1, 0]):
        assert tfleet.imbalance(loads) == jfleet.imbalance(loads)
    for specs, n in (([("a", 8), ("a", 8)], 2), ([("a", 8)], 0)):
        with pytest.raises(ValueError) as jerr:
            jfleet.plan_placement([jfleet.TenantSpec(*s) for s in specs], n)
        with pytest.raises(ValueError) as terr:
            tfleet.plan_placement([tfleet.TenantSpec(*s) for s in specs], n)
        assert str(terr.value) == str(jerr.value)
    assert tfleet.DEFAULT_SHARD_THRESHOLD == jfleet.DEFAULT_SHARD_THRESHOLD
    assert tfleet.BATCHED_KINDS == jfleet.BATCHED_KINDS
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)


def test_size_plan_matches_solver_plan():
    """The planner's costing primitive and ``Solver.plan()`` read one
    work model."""
    from repro_torch.api import Solver
    g = G.grid_road(8, seed=0)
    sp = tfleet.size_plan(g.num_nodes, g.num_edges)
    real = Solver.open(g.edges, num_nodes=g.num_nodes, device="cpu").plan()
    assert sp.backend == real.backend
    for k in ("hook_ops_per_round", "jump_ops_per_sweep"):
        assert sp.predicted[k] == real.predicted[k]


# ---------------------------------------------------------------------------
# one device, request by request against the reference
# ---------------------------------------------------------------------------

def _norm(r) -> tuple:
    res = r.result
    if res is not None and not isinstance(res, (int, np.ndarray)):
        res = int(res)                   # a device version scalar
    if isinstance(res, np.ndarray):
        res = (res.dtype.kind, res.tolist())
    return (r.uid, r.tenant, r.kind, r.done, r.error, res)


TENANTS = {"a": 48, "b": 48, "c": 32}
WHALE = 1 << 10


def _stream(seed: int = 0) -> list:
    """Ticks of (tenant, kind, payload) submissions; ``("drop", name)``
    drops a tenant with its requests still queued."""
    rng = np.random.default_rng(seed)
    ticks = []
    for tick in range(5):
        subs = []
        for t, n in TENANTS.items():
            e = rng.integers(0, n, (int(rng.integers(4, 20)), 2))
            subs.append((t, "insert", e.astype(np.int32)))
            if tick >= 2:
                subs.append((t, "delete", e[:2].astype(np.int32)))
            for _ in range(2):
                subs.append((t, "same_component",
                             rng.integers(-n, n + 5, (5, 2))))
            subs.append((t, "component_size", rng.integers(0, n, 3)))
            subs.append((t, "count_components", None))
            subs.append((t, "component_histogram", None))
        chain = np.stack([np.arange(tick * 60, tick * 60 + 60),
                          np.arange(tick * 60 + 1, tick * 60 + 61)], 1)
        subs.append(("whale", "insert", chain))
        if tick == 3:
            subs.append(("whale", "delete", chain[10:12]))
        subs.append(("whale", "same_component",
                     rng.integers(0, WHALE, (7, 2))))
        subs.append(("whale", "component_size", rng.integers(0, WHALE, 4)))
        subs.append(("whale", "count_components", None))
        subs.append(("whale", "component_histogram", None))
        if tick == 4:
            subs.append(("drop", "c"))
        ticks.append(subs)
    return ticks


def _drive(fs, ticks) -> list:
    """Submit tick by tick, one ``step()`` after each; returns the
    retired requests of every step and of the final ``run()``."""
    out = []
    for subs in ticks:
        for sub in subs:
            if sub[0] == "drop":
                fs.drop(sub[1])
            else:
                fs.submit(*sub)
        out.append([_norm(r) for r in fs.step()])
    out.append([_norm(r) for r in fs.run()])
    return out


@pytest.mark.parametrize("slots", (8, 64))
def test_fleet_matches_reference_request_by_request(slots):
    kw = dict(slots_per_device=slots, rebalance_every=0,
              shard_threshold=1 << 11)
    want_fs = jfleet.FleetService(**kw)
    got_fs = _cpu_fleet(**kw)
    for fs in (want_fs, got_fs):
        for t, n in TENANTS.items():
            fs.admit(t, n, expected_edges=64)
        fs.admit("whale", WHALE, expected_edges=1 << 12)
    assert got_fs.placement_of("whale") == "mesh"
    ticks = _stream()
    want, got = _drive(want_fs, ticks), _drive(got_fs, ticks)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert sum(len(x) for x in got) > 100
    assert any(r[4] is not None for x in got for r in x)  # the dropped c
    assert got_fs.stats_summary() == want_fs.stats_summary()
    assert got_fs.tenants() == want_fs.tenants()
    for t in ("a", "b"):
        shard = got_fs.shards[got_fs.placement_of(t)]
        jshard = want_fs.shards[want_fs.placement_of(t)]
        np.testing.assert_array_equal(
            shard.registry.get(t).labels.numpy(),
            np.asarray(jshard.registry.get(t).labels))
    np.testing.assert_array_equal(
        got_fs._sharded["whale"].labels.numpy(),
        np.asarray(want_fs._sharded["whale"].labels))


def test_fleet_slo_counts_match_reference():
    """Tracing on: the merged SLO has the reference's counts per tenant
    and kind, and ``obs_summary`` the same fleet stats."""
    kw = dict(slots_per_device=16, rebalance_every=0,
              shard_threshold=1 << 11)
    summaries = []
    for fs, obs in ((jfleet.FleetService(**kw), jobs),
                    (_cpu_fleet(**kw), tobs)):
        obs.enable()
        try:
            for t, n in TENANTS.items():
                fs.admit(t, n, expected_edges=64)
            fs.admit("whale", WHALE, expected_edges=1 << 12)
            _drive(fs, _stream(3))
            summaries.append((fs.slo_summary(), fs.obs_summary()))
        finally:
            obs.disable()

    def counts(s):
        return ({k: v["count"] for k, v in s["global"].items()},
                {t: {k: v["count"] for k, v in kinds.items()}
                 for t, kinds in s["tenants"].items()})
    (jslo, jsum), (tslo, tsum) = summaries
    assert counts(tslo) == counts(jslo)
    assert tsum["fleet"] == jsum["fleet"] and tsum["ticks"] == jsum["ticks"]


def test_fleet_pipeline_retires_one_tick_late():
    """A query dispatched in tick N retires in tick N+1; ``run()``
    drains the tail, ``step()`` shows it."""
    fs = _cpu_fleet(slots_per_device=8, rebalance_every=0)
    fs.admit("t", 16)
    fs.submit_insert("t", [[0, 1], [1, 2]])
    fs.run()
    fs.submit_query("t", "same_component", [[0, 2], [0, 3]])
    first = fs.step()
    assert first == []
    assert fs.inflight
    second = fs.step()
    assert [r.done for r in second] == [True]
    np.testing.assert_array_equal(np.asarray(second[0].result),
                                  [True, False])
    assert not fs.inflight


def test_fleet_unknown_tenant_and_bad_kind_match_reference():
    jfs = jfleet.FleetService(rebalance_every=0)
    tfs = _cpu_fleet(rebalance_every=0)
    for fs in (jfs, tfs):
        fs.admit("t", 8)
        fs.admit("w", 1 << 10, expected_edges=1 << 23)   # sharded
    calls = [
        lambda fs: fs.submit_query("nope", "count_components"),
        lambda fs: fs.submit_query("t", "insert"),
        lambda fs: fs.submit("w", "bogus"),
        lambda fs: fs.submit("w", "same_component"),
        lambda fs: fs.submit("w", "insert"),
        lambda fs: fs.admit("t", 8),
        lambda fs: fs.placement_of("nope"),
        lambda fs: fs.drop("nope"),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(Exception) as jerr:
            call(jfs)
        with pytest.raises(Exception) as terr:
            call(tfs)
        assert (type(terr.value), str(terr.value)) == \
            (type(jerr.value), str(jerr.value)), i
    assert tfs.placement_of("t") == 0 and tfs.placement_of("w") == "mesh"
    tfs.drop("t")
    tfs.drop("w")
    assert tfs.tenants() == []


def test_fleet_defaults_to_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        tfleet.FleetService()
    fs = tfleet.FleetService(["cpu"] * 3)
    assert fs.devices == [torch.device("cpu")] * 3
    assert fs.mesh.shape == {"data": 3}
    assert all(s.device.type == "cpu" for s in fs.shards)
    with pytest.raises(ValueError, match="at least one device"):
        tfleet.FleetService([])
    with pytest.raises(ValueError, match="different mesh"):
        tfleet.FleetService(["cpu"] * 2, runners=fs.runners)
    shared = tfleet.FleetService(["cpu"] * 3, runners=fs.runners)
    assert shared.runners is fs.runners


# ---------------------------------------------------------------------------
# the reference's single-device cases
# ---------------------------------------------------------------------------

def test_fleet_all_query_kinds_and_batching():
    """The cross-tenant batcher collapses same-|V| same-kind traffic into
    ONE dispatch per (kind, |V|) group; answers equal the oracle's."""
    n = 32
    rng = np.random.default_rng(3)
    fs = _cpu_fleet(slots_per_device=64, rebalance_every=0)
    oracle = {}
    for i in range(4):
        t = f"q{i}"
        fs.admit(t, n)
        e = rng.integers(0, n, (20, 2)).astype(np.int32)
        fs.submit_insert(t, e)
        oracle[t] = DynamicConnectivityOracle(n)
        oracle[t].insert(e)
    fs.run()
    calls_before = fs.shards[0].stats["query_calls"]
    uids, payloads = {}, {}
    for t in oracle:
        payloads[t] = (rng.integers(0, n, (5, 2)), rng.integers(0, n, (3,)))
        uids[t, "same_component"] = fs.submit_query(
            t, "same_component", payloads[t][0])
        uids[t, "component_size"] = fs.submit_query(
            t, "component_size", payloads[t][1])
        uids[t, "count_components"] = fs.submit_query(t, "count_components")
        uids[t, "component_histogram"] = fs.submit_query(
            t, "component_histogram")
    done = {r.uid: r for r in fs.run()}
    assert all(r.error is None for r in done.values())
    assert fs.shards[0].stats["query_calls"] - calls_before == 2 + 8
    for t, oc in oracle.items():
        labels = oc.labels()
        pairs, verts = payloads[t]
        np.testing.assert_array_equal(
            done[uids[t, "same_component"]].result,
            labels[pairs[:, 0]] == labels[pairs[:, 1]])
        sizes = np.bincount(labels, minlength=n)[labels]
        np.testing.assert_array_equal(
            done[uids[t, "component_size"]].result, sizes[verts])
        assert done[uids[t, "count_components"]].result == \
            len(np.unique(labels))
        hist = np.asarray(done[uids[t, "component_histogram"]].result)
        assert int(hist.sum()) == len(np.unique(labels))


def test_fleet_matches_dynamic_oracle_with_device_graph_payloads():
    """Mixed DeviceGraph and host payloads through the pipelined tick;
    answers equal the dynamic oracle's after inserts and deletes."""
    g = G.grid_road(8, extra_prob=0.0, seed=0)
    n, edges = g.num_nodes, np.asarray(g.edges, np.int32)
    fs = _cpu_fleet(slots_per_device=16, rebalance_every=0)
    fs.admit("t", n)
    fs.submit_insert("t", edges[:-20])
    fs.run()
    fs.submit_delete("t", edges[:10])
    fs.submit_insert("t", DeviceGraph.from_edges(edges[-20:-10], n,
                                                 device="cpu"))
    fs.submit_insert("t", DeviceGraph.from_edges(edges[-10:], n,
                                                 device="cpu"))
    fs.submit_query("t", "same_component", edges[8:16])
    assert fs.step() == []
    finished = fs.run()
    assert [r.error for r in finished] == [None] * 4
    assert isinstance(finished[0].result, torch.Tensor)   # a version
    fs.submit_delete("t", DeviceGraph.from_edges(edges[10:20], n,
                                                 device="cpu"))
    fs.run()
    oracle = DynamicConnectivityOracle(n)
    oracle.insert(edges[:-20])
    oracle.delete(edges[:10])
    oracle.insert(edges[-20:])
    oracle.delete(edges[10:20])
    labels = oracle.labels()
    pairs = np.stack([np.arange(n, dtype=np.int32),
                      np.zeros(n, np.int32)], 1)
    fs.submit_query("t", "same_component", pairs)
    got = np.asarray(fs.run()[0].result)
    np.testing.assert_array_equal(got, labels[pairs[:, 0]] == labels[0])


def test_fleet_promotion_to_sharded_class():
    """A packed tenant whose LIVE work crosses the threshold is promoted
    to the sharded class at the next rebalance poll, answers intact, as
    in the reference."""
    n = 256
    kw = dict(slots_per_device=32, shard_threshold=n + 60,
              rebalance_every=1, rebalance_factor=0.9)
    out = []
    for fs in (jfleet.FleetService(**kw), _cpu_fleet(**kw)):
        fs.admit("small", n, expected_edges=8)
        chain = np.stack([np.arange(40), np.arange(40) + 1], 1)
        fs.submit_insert("small", chain)
        fs.run()
        before = fs.placement_of("small")
        fs.submit_insert("small", chain + 100)
        fs.run()
        for _ in range(3):
            fs.step()
        fs.submit_query("small", "same_component",
                        [[0, 40], [0, 141], [0, 99]])
        done = fs.run()
        out.append((before, fs.placement_of("small"), fs.stats["promotions"],
                    [_norm(r)[2:] for r in done], fs.stats_summary()))
    assert out[1] == out[0]
    assert out[1][:3] == (0, "mesh", 1)
    assert out[1][3][0][3] == ("b", [True, False, False])


def test_fleet_sharded_tenant_lifecycle_single_device():
    """A sharded tenant: mutations accumulate in the log, queries
    re-solve lazily (once per dirty window, not once per query)."""
    n = 1 << 10
    fs = _cpu_fleet(shard_threshold=1 << 10, rebalance_every=0)
    fs.admit("whale", n, expected_edges=1 << 12)
    assert fs.placement_of("whale") == "mesh"
    chain = np.stack([np.arange(200), np.arange(200) + 1], 1)
    fs.submit_insert("whale", chain)
    fs.submit_query("whale", "same_component", [[0, 200], [0, 201]])
    fs.submit_query("whale", "count_components")
    done = fs.run()
    assert [r.error for r in done] == [None] * 3
    by_kind = {r.kind: r for r in done}
    np.testing.assert_array_equal(by_kind["same_component"].result,
                                  [True, False])
    assert by_kind["count_components"].result == n - 200
    assert fs.stats["sharded_resolves"] == 1
    fs.submit_delete("whale", [[100, 101]])
    fs.submit_query("whale", "same_component", [[0, 100], [0, 101]])
    done = fs.run()
    assert [r.error for r in done] == [None, None]
    q = [r for r in done if r.kind == "same_component"][0]
    np.testing.assert_array_equal(q.result, [True, False])
    assert fs.stats["sharded_resolves"] == 2
    assert fs.runners.stats == {"hits": 1, "misses": 1}


def test_fleet_slo_merged_percentiles_exact():
    """The merged p50/p99 equals one recorder fed the union stream (bucket
    counts summed), not an average of per-shard percentiles."""
    tobs.enable()
    try:
        fs = _cpu_fleet(2, rebalance_every=0)
        fs.admit("a", 16)
        fs.admit("b", 16)
        assert {fs.placement_of("a"), fs.placement_of("b")} == {0, 1}
        rng = np.random.default_rng(0)
        for t in ("a", "b"):
            fs.submit_insert(t, rng.integers(0, 16, (8, 2)))
        fs.run()
        for t in ("a", "b"):
            for _ in range(5):
                fs.submit_query(t, "same_component",
                                rng.integers(0, 16, (4, 2)))
        fs.run()
        merged = fs.slo()
        want = SLORecorder()
        for rec in [s.slo for s in fs.shards] + [fs.mesh_slo]:
            for (tenant, kind), h in rec._hists.items():
                union = want._hists.setdefault(
                    (tenant, kind), LatencyHistogram(want.spec))
                union.counts = union.counts + h.counts
        assert merged.summary() == want.summary()
        gl = merged.summary()["global"]
        assert gl["same_component"]["count"] == 10
        assert gl["insert"]["count"] == 2
        assert set(merged.summary()["tenants"]) == {"a", "b"}
    finally:
        tobs.disable()


def test_engine_composes_with_bare_services():
    """The engine runs over plain services, as the reference's does."""
    got = []
    for svc, eng_cls in ((JService(slots=8), jfleet.PipelinedTickEngine),
                         (TService(slots=8, device="cpu"),
                          tfleet.PipelinedTickEngine)):
        svc.registry.create("t", 8)
        eng = eng_cls([svc])
        svc.submit_insert("t", [[0, 1]])
        svc.submit_query("t", "same_component", [[0, 1], [2, 3]])
        first = eng.tick()
        done = eng.flush()
        got.append((first, [_norm(r)[1:] for r in done], dict(eng.stats),
                    dict(svc.stats)))
    assert got[1] == got[0]
    assert got[1][2]["batched_dispatches"] == 1


# ---------------------------------------------------------------------------
# eight slots in process (the reference runs these on 8 forced devices)
# ---------------------------------------------------------------------------

def test_fleet_8dev_placement_throughput_and_oracle():
    """Tenants spread over every slot, mixed traffic matches the dynamic
    oracle, a sharded tenant solves across the mesh."""
    n = 32
    rng = np.random.default_rng(1)
    fs = _cpu_fleet(8, slots_per_device=64, shard_threshold=1 << 11,
                    rebalance_every=0)
    tenants = [f"t{i}" for i in range(16)]
    oracles = {}
    for t in tenants:
        fs.admit(t, n, expected_edges=48)
        oracles[t] = DynamicConnectivityOracle(n)
    owners = {fs.placement_of(t) for t in tenants}
    assert owners == set(range(8)), owners
    for t in tenants:
        e = rng.integers(0, n, (24, 2)).astype(np.int32)
        fs.submit_insert(t, e)
        oracles[t].insert(e)
    fs.run()
    expect = {}
    for t in tenants:
        pairs = rng.integers(0, n, (6, 2)).astype(np.int32)
        expect[fs.submit_query(t, "same_component", pairs)] = (t, pairs)
    done = {r.uid: r for r in fs.run()}
    assert all(r.error is None for r in done.values())
    for uid, (t, pairs) in expect.items():
        labels = oracles[t].labels()
        want = labels[pairs[:, 0]] == labels[pairs[:, 1]]
        np.testing.assert_array_equal(np.asarray(done[uid].result), want,
                                      err_msg=t)
    assert all(s.stats["ticks"] > 0 for s in fs.shards)
    fs.admit("whale", 1 << 11, expected_edges=1 << 12)
    assert fs.placement_of("whale") == "mesh"
    chain = np.stack([np.arange(500), np.arange(500) + 1], 1)
    fs.submit_insert("whale", chain)
    fs.submit_query("whale", "same_component", [[0, 500], [0, 501]])
    done = fs.run()
    assert [r.error for r in done] == [None, None]
    q = [r for r in done if r.kind == "same_component"][0]
    np.testing.assert_array_equal(np.asarray(q.result), [True, False])
    assert fs._sharded["whale"].runners.mesh.size == 8


def test_fleet_8dev_rebalance_migrates_drifted_tenants():
    """Load drift (one tenant ballooning) trips the imbalance trigger; the
    rebalancer migrates packed tenants off the hot slot and answers stay
    oracle-correct after the move."""
    n = 64
    rng = np.random.default_rng(5)
    fs = _cpu_fleet(8, slots_per_device=64, rebalance_every=2,
                    rebalance_factor=1.5, shard_threshold=1 << 30)
    tenants = [f"t{i}" for i in range(16)]
    oracles = {}
    for t in tenants:
        fs.admit(t, n, expected_edges=16)
        oracles[t] = DynamicConnectivityOracle(n)
    hot = tenants[0]
    for _ in range(4):
        e = rng.integers(0, n, (256, 2)).astype(np.int32)
        fs.submit_insert(hot, e)
        oracles[hot].insert(e)
        fs.run()
    assert fs.stats["migrations"] > 0, fs.stats
    for t in tenants:
        pairs = rng.integers(0, n, (6, 2)).astype(np.int32)
        uid = fs.submit_query(t, "same_component", pairs)
        done = {r.uid: r for r in fs.run()}
        labels = oracles[t].labels()
        want = labels[pairs[:, 0]] == labels[pairs[:, 1]]
        np.testing.assert_array_equal(np.asarray(done[uid].result), want,
                                      err_msg=t)
