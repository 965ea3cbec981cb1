"""repro_torch's connectivity registry and service against
repro.connectivity: one seeded request stream (inserts, deletes, all
four query kinds, an unknown tenant, out-of-bounds payloads, a tenant
created after its submit, tensor payloads, and more requests than
slots) through both services gives, request for request, the same
``result``, ``done`` and error kind, the same ``stats``,
``registry.stats()``, final labels and version-stamped cache hits; with
tracing on, the same SLO counts and device metrics. Integer work: the
tolerance is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.connectivity import policy as jpolicy
from repro.connectivity import registry as jreg, service as jsvc
from repro_torch import obs as tobs
from repro_torch.connectivity import policy as tpolicy
from repro_torch.connectivity import registry as treg, service as tsvc

TENANTS = {"a": 64, "b": 100}


def _stream(seed: int = 0) -> list:
    """The request stream as (action, tenant, kind, payload) steps;
    action is "submit", "create" or "run". Payload arrays are numpy;
    ``("tensor", arr)`` is handed to each side as its own device array."""
    rng = np.random.default_rng(seed)
    steps, inserted = [], {t: [] for t in TENANTS}
    for tick in range(5):
        for t, n in TENANTS.items():
            e = rng.integers(0, n, (int(rng.integers(6, 20)), 2))
            e = e.astype(np.int32)
            inserted[t].append(e)
            payload = ("tensor", e) if tick == 3 else e
            steps.append(("submit", t, "insert", payload))
            if tick >= 1:
                pool = np.concatenate(inserted[t])
                dels = pool[rng.integers(0, pool.shape[0], 3)]
                steps.append(("submit", t, "delete", dels))
            for _ in range(2):
                steps.append(("submit", t, "same_component",
                              rng.integers(0, n, (6, 2))))
            steps.append(("submit", t, "component_size",
                          rng.integers(0, n, 5)))
            steps.append(("submit", t, "count_components", None))
            steps.append(("submit", t, "component_histogram", None))
        if tick == 1:
            steps.append(("submit", "ghost", "same_component",
                          np.zeros((2, 2), np.int32)))
            steps.append(("submit", "ghost", "insert",
                          np.zeros((2, 2), np.int32)))
            steps.append(("submit", "ghost", "count_components", None))
        if tick == 2:
            # rejected at admission (the tenant exists: bounds checked)
            steps.append(("submit", "a", "insert",
                          np.asarray([[0, 64]], np.int32)))
            # rejected in the tick: a query vertex out of range
            steps.append(("submit", "b", "same_component",
                          np.asarray([[0, 100]], np.int32)))
            # a tenant made after its submits: re-bound with the check
            steps.append(("submit", "late", "insert",
                          np.asarray([[0, 1], [2, 3]], np.int32)))
            steps.append(("submit", "late", "count_components", None))
            steps.append(("create", "late", None, 30))
        if tick == 3:
            steps.append(("submit", "late", "insert",
                          np.asarray([[4, 5]], np.int32)))
            steps.append(("submit", "early", "insert",
                          np.asarray([[0, 40]], np.int32)))
            steps.append(("create", "early", None, 10))
        # the same batch twice in one tick: one microbatch
        steps.append(("submit", "a", "same_component",
                      np.asarray([[1, 2], [3, 4]], np.int32)))
        steps.append(("submit", "a", "same_component",
                      np.asarray([[1, 2], [3, 4]], np.int32)))
        steps.append(("run", None, None, None))
    # the same queries again with no mutation between: version-stamped
    # cache hits
    for _ in range(2):
        steps.append(("submit", "b", "component_size",
                      np.asarray([0, 1, 2], np.int32)))
        steps.append(("submit", "b", "count_components", None))
        steps.append(("run", None, None, None))
    return steps


def _drive(side: str, steps: list, slots: int = 8):
    if side == "ref":
        registry = jreg.GraphRegistry(
            policy_cache=jpolicy.AutotuneCache(None))
        svc = jsvc.ConnectivityService(registry, slots=slots)
        as_array = jnp.asarray
    else:
        registry = treg.GraphRegistry(
            policy_cache=tpolicy.AutotuneCache(None), device="cpu")
        svc = tsvc.ConnectivityService(registry, slots=slots)
        as_array = torch.from_numpy
    for t, n in TENANTS.items():
        registry.create(t, n)
    log = []
    for action, tenant, kind, payload in steps:
        if action == "create":
            registry.create(tenant, payload)
        elif action == "run":
            log.extend(svc.run())
        else:
            if isinstance(payload, tuple):
                payload = as_array(payload[1])
            try:
                svc.submit(tenant, kind, payload)
            except ValueError as err:
                log.append(("refused", tenant, kind, str(err)))
    return svc, log


def _view(entry) -> tuple:
    """A retired request (or an admission refusal) as comparable data."""
    if isinstance(entry, tuple):
        return entry
    r = entry
    err = None if r.error is None else r.error.split(":")[0]
    if r.error is not None or r.result is None:
        result = None
    elif r.kind in ("insert", "delete", "count_components"):
        result = int(r.result)
    else:
        result = np.asarray(r.result).tolist()
    return (r.uid, r.tenant, r.kind, r.done, err, result)


@pytest.mark.parametrize("slots", [8, 3, 64])
def test_service_matches_reference_request_for_request(slots):
    steps = _stream()
    jsvc_, jlog = _drive("ref", steps, slots)
    tsvc_, tlog = _drive("port", steps, slots)
    assert [_view(e) for e in tlog] == [_view(e) for e in jlog]
    assert tsvc_.stats == jsvc_.stats
    assert tsvc_.registry.stats() == jsvc_.registry.stats()
    assert tsvc_.stats["errors"] > 0 and not tsvc_.queue
    hits = sum(s["cache_hits"] for s in tsvc_.registry.stats().values())
    assert hits > 0
    for name in jsvc_.registry.names():
        np.testing.assert_array_equal(
            tsvc_.registry.get(name).labels.numpy(),
            np.asarray(jsvc_.registry.get(name).labels))
        np.testing.assert_array_equal(
            tsvc_.registry.get(name).edges(),
            np.asarray(jsvc_.registry.get(name).edges()))
    # nothing traced: no SLO recorded
    assert tsvc_.slo.summary() == {"global": {}, "tenants": {}}


def test_traced_service_records_the_reference_slo_counts():
    steps = _stream(seed=1)
    jtr, ttr = jobs.enable(capacity=1 << 12), tobs.enable(capacity=1 << 12)
    jtr.reset()
    ttr.reset()
    try:
        jsvc_, jlog = _drive("ref", steps)
        tsvc_, tlog = _drive("port", steps)
        jsum, tsum = jsvc_.obs_summary(), tsvc_.obs_summary()
    finally:
        jobs.disable()
        tobs.disable()
    assert [_view(e) for e in tlog] == [_view(e) for e in jlog]

    def counts(summary):
        return ({k: v["count"] for k, v in summary["global"].items()},
                {t: {k: v["count"] for k, v in kinds.items()}
                 for t, kinds in summary["tenants"].items()})

    assert counts(tsum["latency"]) == counts(jsum["latency"])
    assert tsum["ticks"] == jsum["ticks"]
    # the port's read counters and engine spans (``PORT_ONLY``) have no
    # counterpart in the reference; every name the reference has is
    # compared exactly
    assert {k: v for k, v in tsum["counters"].items()
            if not k.startswith(tobs.PORT_ONLY)} == jsum["counters"]
    assert tsum["device_metrics"] == jsum["device_metrics"]
    names = [e["name"] for e in ttr.log.events()
             if not e["name"].startswith(tobs.PORT_ONLY)]
    assert names.count("service.tick") == tsum["ticks"]
    assert sorted(set(names)) == sorted(
        {e["name"] for e in jtr.log.events()})


def test_service_device_and_tenant_lifecycle():
    reg = treg.GraphRegistry(device="cpu")
    svc = tsvc.ConnectivityService(reg)
    assert svc.device == reg.device == torch.device("cpu")
    reg.create("x", 4)
    with pytest.raises(ValueError, match="already registered"):
        reg.create("x", 4)
    svc.submit_insert("x", [[0, 1]])
    assert svc.queue[0].payload.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        svc.submit("x", "nope")
    with pytest.raises(ValueError, match="unknown query kind"):
        svc.submit_query("x", "insert", [[0, 1]])
    with pytest.raises(ValueError, match="requires a payload"):
        svc.submit("x", "same_component")
    done = svc.run()
    assert int(done[0].result) == 1 and reg.version("x") == 1
    assert len(reg) == 1 and "x" in reg and reg.names() == ["x"]
    reg.drop("x")
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.get("x")
