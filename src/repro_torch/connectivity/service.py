"""Slot-based connectivity query engine (the port of
``repro.connectivity.service``): microbatched, interleaved insert, delete
and query traffic over the multi-tenant registry.

Every tenant behind the registry is a ``repro_torch.api.Solver`` session,
so the service inherits the facade's policy routing. A bounded number of
request slots per tick: each tick admits queued requests, runs them in
phases and retires them with results.

Per tick:

  * **inserts coalesce per tenant**: all admitted insert batches of one
    tenant concatenate on the device (``DeviceGraph.concat``) into ONE
    registry call. Payloads are checked on the host and copied to the
    service's device at admission, so the tick itself touches device
    tensors only;
  * **deletes coalesce per tenant** the same way: one tombstone and
    scoped recompute per tenant per tick;
  * **queries microbatch per (tenant, kind)**: all admitted
    ``same_component`` pairs (or ``component_size`` vertices) of a
    tenant concatenate into one batch, padded to a power-of-two row
    count.

Consistency model: within a tick, inserts apply first, then deletes,
then queries. A query observes every mutation admitted in its tick and
before, and a delete admitted beside an insert of the same edge wins.

Every query is served from the live label array, with no label
recompute; ``stats["recomputes_avoided"]`` counts the full CC runs a
recompute-per-query design would have paid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.connectivity.registry import GraphRegistry
from repro_torch.graphs.device import (DeviceGraph, resolve_device,
                                       validate_edge_bounds)
from repro_torch.obs import trace as obs
from repro_torch.obs.slo import SLORecorder

QUERY_KINDS = ("same_component", "component_size", "count_components",
               "component_histogram")
MUTATION_KINDS = ("insert", "delete")
KINDS = MUTATION_KINDS + QUERY_KINDS


@dataclasses.dataclass
class Request:
    uid: int
    tenant: str
    kind: str                       # one of KINDS
    # an np array for the query kinds; a DeviceGraph for inserts and
    # deletes (on the service's device from admission on)
    payload: Optional[Any] = None
    result: Any = None
    done: bool = False
    error: Optional[str] = None
    # wall-clock admission stamp (end-to-end latency is collect minus
    # submit)
    t_submit: float = 0.0


class ConnectivityService:
    """Continuous-microbatching engine over a ``GraphRegistry``.

    ``device=`` is where admission puts every payload (the registry's
    device when None; a new registry is made on ``device``)."""

    def __init__(self, registry: GraphRegistry | None = None, *,
                 slots: int = 32, device=None):
        if registry is None:
            registry = GraphRegistry(device=device)
        self.registry = registry
        self.device = registry.device if device is None \
            else resolve_device(device)
        self.slots = slots
        self.queue: list[Request] = []
        self._uid = 0
        # per-(tenant, kind) latency histograms, a fixed-size bucket
        # table; recorded only while repro_torch.obs tracing is on. Query
        # latencies are end to end (the query path reads back its
        # answers); mutation latencies are the host's dispatch time
        self.slo = SLORecorder()
        self.stats = {
            "ticks": 0,
            "inserts_absorbed": 0,        # insert requests completed
            "insert_calls": 0,            # coalesced device-side inserts
            "deletes_absorbed": 0,        # delete requests completed
            "delete_calls": 0,            # coalesced device-side deletes
            "queries_served": 0,          # query requests completed
            "query_calls": 0,             # microbatched query calls
            "pairs_answered": 0,
            "recomputes_avoided": 0,      # vs a recompute-per-query design
            "errors": 0,
        }

    # -- submission --------------------------------------------------------

    def submit(self, tenant: str, kind: str, payload=None) -> int:
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
        if kind in MUTATION_KINDS:
            payload = self._ingest_edges(tenant, kind, payload)
        elif kind in ("same_component", "component_size"):
            if payload is None:
                raise ValueError(f"kind {kind!r} requires a payload")
            if not (isinstance(payload, np.ndarray)
                    and payload.dtype == np.int32):
                payload = np.asarray(payload, np.int32)
            payload = payload.reshape(-1) if kind == "component_size" \
                else payload.reshape(-1, 2)
        else:
            payload = None
        self._uid += 1
        if obs.enabled():
            with obs.span("service.admit", tenant=tenant, kind=kind):
                self.queue.append(Request(self._uid, tenant, kind,
                                          payload,
                                          t_submit=time.perf_counter()))
        else:
            self.queue.append(Request(self._uid, tenant, kind, payload,
                                      t_submit=time.perf_counter()))
        return self._uid

    def _ingest_edges(self, tenant: str, kind: str, payload
                      ) -> DeviceGraph:
        """Admission of an insert or delete payload: bounds-checked on
        the host (a tensor is read back for it), then copied to the
        service's device. DeviceGraph payloads pass through unchecked
        (the caller owns their bounds)."""
        if payload is None:
            raise ValueError(f"kind {kind!r} requires a payload")
        if isinstance(payload, DeviceGraph):
            return payload
        num_nodes = self.registry.get(tenant).num_nodes \
            if tenant in self.registry else None
        if isinstance(payload, torch.Tensor):
            edges = payload.to(torch.int32).reshape(-1, 2)
            if num_nodes is not None:
                validate_edge_bounds(edges.cpu().numpy(), num_nodes)
            edges = edges.to(self.device)
        else:
            arr = np.ascontiguousarray(payload, np.int32).reshape(-1, 2)
            if num_nodes is not None:
                validate_edge_bounds(arr, num_nodes)
            edges = torch.from_numpy(arr).to(self.device)
        if num_nodes is None:
            # unknown tenant: the tick's failure path rejects the group
            # (or ``_rebind`` binds it to a tenant made since)
            num_nodes = 0
        return DeviceGraph.from_edges(edges, num_nodes)

    def submit_insert(self, tenant: str, edges) -> int:
        return self.submit(tenant, "insert", edges)

    def submit_delete(self, tenant: str, edges) -> int:
        return self.submit(tenant, "delete", edges)

    def submit_query(self, tenant: str, kind: str, payload=None) -> int:
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; "
                             f"choose from {QUERY_KINDS}")
        return self.submit(tenant, kind, payload)

    # -- the engine tick ---------------------------------------------------

    def _fail(self, req: Request, err: Exception) -> None:
        req.error = f"{type(err).__name__}: {err}"
        req.done = True
        self.stats["errors"] += 1

    @staticmethod
    def _rebind(payload: DeviceGraph, num_nodes: int) -> DeviceGraph:
        """Bind a payload submitted before its tenant existed (|V| = 0)
        to the tenant's |V|, with the bounds check it skipped at
        admission (a read back, on this rare path only)."""
        validate_edge_bounds(payload.edges.cpu().numpy(), num_nodes)
        return DeviceGraph.from_edges(payload.edges, num_nodes)

    def _run_mutations(self, kind: str, reqs_in: list[Request]) -> None:
        """The coalesced mutation phase of one kind ('insert' or
        'delete')."""
        by_tenant: dict[str, list[Request]] = {}
        for r in reqs_in:
            by_tenant.setdefault(r.tenant, []).append(r)
        registry_call = getattr(self.registry, kind)
        record = obs.enabled()
        for tenant, reqs in by_tenant.items():
            with obs.span(f"service.{kind}", tenant=tenant,
                          requests=len(reqs)) as sp:
                t0 = time.perf_counter()
                try:
                    # one concat and ONE registry call per tenant per
                    # tick. Only payloads submitted before the tenant
                    # existed (|V| = 0) re-bind to its |V|; a real |V|
                    # mismatch falls through to the registry's error
                    n = self.registry.get(tenant).num_nodes
                    batch = DeviceGraph.concat(
                        [self._rebind(r.payload, n) if
                         r.payload.num_nodes == 0 and n != 0 else r.payload
                         for r in reqs])
                    version = registry_call(tenant, batch)
                except Exception as err:  # fail the group, not the tick
                    for r in reqs:
                        self._fail(r, err)
                    sp.tag(failed=len(reqs))
                    continue
                sp.tag(route=self.registry.get(tenant).last_method)
                dt = time.perf_counter() - t0
            if record:
                # dispatch latency, shared by the coalesced group
                for _ in reqs:
                    self.slo.record(tenant, kind, dt)
            self.stats[f"{kind}_calls"] += 1
            for r in reqs:
                # the version rides as a device scalar; int(...) it to
                # read it (the tick does not)
                r.result = version
                r.done = True
                self.stats[f"{kind}s_absorbed"] += 1

    def _run_query_group(self, tenant: str, kind: str,
                         reqs: list[Request]) -> None:
        with obs.span(f"service.query.{kind}", tenant=tenant,
                      requests=len(reqs)) as sp:
            t0 = time.perf_counter()
            try:
                if kind in ("same_component", "component_size"):
                    parts = [r.payload for r in reqs]
                    flat = np.concatenate(parts, axis=0)
                    answers = getattr(self.registry, kind)(tenant, flat)
                    self.stats["query_calls"] += 1
                    self.stats["pairs_answered"] += int(flat.shape[0])
                    sp.tag(rows=int(flat.shape[0]))
                    off = 0
                    for r, part in zip(reqs, parts):
                        r.result = answers[off:off + part.shape[0]]
                        off += part.shape[0]
                else:               # scalar / histogram: one call serves all
                    answer = getattr(self.registry, kind)(tenant)
                    self.stats["query_calls"] += 1
                    for r in reqs:
                        r.result = answer
            except Exception as err:     # fail the group, not the tick
                for r in reqs:
                    self._fail(r, err)
                sp.tag(failed=len(reqs))
                return
            dt = time.perf_counter() - t0
        if obs.enabled():
            # end to end: the query path reads back its answers, so the
            # wall time is the request latency
            for _ in reqs:
                self.slo.record(tenant, kind, dt)
        for r in reqs:
            r.done = True
            self.stats["queries_served"] += 1
            self.stats["recomputes_avoided"] += 1

    def _pop_admitted(self) -> list[Request]:
        """Snapshot and remove this tick's admitted slice. The snapshot
        is taken once and exactly that many entries leave the head, so
        a ``submit()`` landing mid-tick (a callback enqueueing follow-up
        work) appends past it and survives to the next tick."""
        admitted = self.queue[: self.slots]
        del self.queue[: len(admitted)]
        return admitted

    def step(self) -> list[Request]:
        """One tick: admit up to ``slots`` requests, coalesce inserts
        then deletes, microbatch queries, retire. Returns the retired
        requests."""
        admitted = self._pop_admitted()
        if not admitted:
            return []
        self.stats["ticks"] += 1
        with obs.span("service.tick", step=self.stats["ticks"],
                      admitted=len(admitted)):
            for kind in MUTATION_KINDS:   # inserts apply before deletes
                self._run_mutations(
                    kind, [r for r in admitted if r.kind == kind])
            groups: dict[tuple[str, str], list[Request]] = {}
            for r in admitted:
                if r.kind not in MUTATION_KINDS:
                    groups.setdefault((r.tenant, r.kind), []).append(r)
            for (tenant, kind), reqs in groups.items():
                self._run_query_group(tenant, kind, reqs)
        return admitted

    def run(self) -> list[Request]:
        """Drain the queue; returns every retired request in admit
        order."""
        finished: list[Request] = []
        while self.queue:
            finished.extend(self.step())
        return finished

    # -- telemetry ---------------------------------------------------------

    def obs_summary(self) -> dict:
        """The tick summary: per-tenant and global latency SLOs, the
        always-on host counters, and the tenants' device metrics merged
        with ``Metrics.merge`` and read back once
        (``obs.metrics.flush``)."""
        from repro_torch.obs import metrics as obs_metrics
        merged = None
        for name in self.registry.names():
            m = self.registry.get(name).solver.metrics
            if m is not None:
                merged = m if merged is None else merged.merge(m)
        return {
            "ticks": self.stats["ticks"],
            "latency": self.slo.summary(),
            "counters": dict(obs.tracer().counters),
            "device_metrics": (None if merged is None
                               else obs_metrics.flush(merged)),
        }
