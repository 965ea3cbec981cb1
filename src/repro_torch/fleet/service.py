"""Fleet front door: one admit/submit/step/retire surface over a mesh
of devices (DESIGN.md §15), the port of ``repro.fleet.service``.

``FleetService`` composes the rest of the port into a multi-device
serving plane:

  * **packed tenants** ride thin per-device shells: one
    ``ConnectivityService`` per device (``device=`` puts every payload
    and every session's dynamic state there), ticked together by the
    ``PipelinedTickEngine`` so that the host dispatches every shard's
    work before waiting on any of it;
  * **sharded tenants** (predicted work >= ``shard_threshold``) are too
    big for one device: each owns an ``EdgeLog`` on slot 0's device
    whose alive view re-solves through the multi-shard engine across
    the WHOLE mesh (``DistributedRunnerCache`` keeps one engine per
    capacity bucket), and their queries run on the merged labels:
    dispatched this tick, collected next tick, as on the packed path;
  * **rebalancing**: every ``rebalance_every`` ticks the service reads
    each device's LIVE load (host-known edge counts through the
    ``predicted_work`` model placement packs on) and, when
    ``imbalance`` crosses ``rebalance_factor``, replans and migrates the
    drifted tenants (edges come back to the host, the tenant re-opens
    on its new device). Tenants whose live work crosses the shard
    threshold are promoted to the sharded class the same way.

A mesh here is a list of devices, one shard slot each; a device may be
listed more than once (``FleetService(devices=["cpu"] * 8)``, or four
slots on one GPU), and then carries that many shards.

SLO accounting: each shard's ``SLORecorder`` is the per-device
recorder; sharded-tenant latencies land in ``mesh_slo``. ``slo()``
merges them with ``obs.merge_recorders``: exact bucket-count sums, so
the global percentiles are those of the union stream.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.connectivity import policy, queries
from repro_torch.connectivity.service import (KINDS, MUTATION_KINDS,
                                              QUERY_KINDS,
                                              ConnectivityService, Request)
from repro_torch.core.batch import pad_rows_pow2
from repro_torch.core.distributed import DistributedRunnerCache
from repro_torch.fleet.engine import (PipelinedTickEngine, _start_to_host,
                                      _to_device)
from repro_torch.fleet.placement import (DEFAULT_SHARD_THRESHOLD,
                                         TenantSpec, imbalance,
                                         plan_placement, predicted_work)
from repro_torch.graphs.device import (DeviceGraph, EdgeLog,
                                       validate_edge_bounds)
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import trace as obs
from repro_torch.obs.slo import SLORecorder, merge_recorders


class ShardedTenant:
    """One mesh-wide tenant: a tombstone log on slot 0's device,
    re-solved through the multi-shard engine. Labels are lazy:
    mutations only mark the partition dirty; the next query (or an
    explicit ``resolve()``) runs ONE mesh solve for however many
    mutations accumulated."""

    def __init__(self, name: str, num_nodes: int,
                 runners: DistributedRunnerCache):
        self.name = name
        self.num_nodes = int(num_nodes)
        self.runners = runners
        self.device = runners.mesh.slot_devices(runners.axis_names)[0]
        self.log = EdgeLog(num_nodes, device=self.device)
        self.num_edges = 0              # host-known inserted total
        self.version = 0                # mutations applied
        self.resolves = 0
        self._labels = None
        self._dirty = True              # an empty graph still needs labels

    def _coerce(self, edges) -> DeviceGraph:
        if isinstance(edges, DeviceGraph):
            if edges.num_nodes not in (0, self.num_nodes):
                raise ValueError(f"delta num_nodes {edges.num_nodes} != "
                                 f"{self.num_nodes}")
            if edges.num_nodes == 0:
                return DeviceGraph.from_edges(edges.edges, self.num_nodes)
            return edges
        arr = np.asarray(edges, np.int32).reshape(-1, 2)
        validate_edge_bounds(arr, self.num_nodes)
        return DeviceGraph.from_edges(arr, self.num_nodes, name=self.name,
                                      device=self.device)

    def insert(self, edges) -> int:
        delta = self._coerce(edges)
        self.log.append(delta)
        self.num_edges += delta.true_edges
        self._dirty = True
        self.version += 1
        return self.version

    def delete(self, edges) -> int:
        if isinstance(edges, DeviceGraph):
            dels, d_true = edges.edges.to(self.device), edges.true_edges
        else:
            arr = np.asarray(edges, np.int32).reshape(-1, 2)
            validate_edge_bounds(arr, self.num_nodes)
            dels = torch.from_numpy(pad_rows_pow2(arr)).to(self.device)
            d_true = arr.shape[0]
        self.log.delete(dels, d_true)
        self._dirty = True
        self.version += 1
        return self.version

    def resolve(self) -> torch.Tensor:
        """Labels [V] on slot 0's device, re-solving the alive view
        across the mesh iff a mutation landed since the last solve. The
        log's power-of-two capacity is the runner-cache key, so
        steady-state re-solves reuse one engine."""
        if self._dirty or self._labels is None:
            self._labels = self.runners.solve(self.log.view())
            self.resolves += 1
            self._dirty = False
        return self._labels

    @property
    def labels(self) -> torch.Tensor:
        return self.resolve()


class FleetService:
    """Sharded multi-tenant connectivity serving over a mesh of devices
    (every visible CUDA device when ``devices`` is None; without CUDA it
    raises unless devices are given).

    ``admit()`` places a tenant (packed onto the least-loaded device,
    or sharded across the mesh when its predicted work crosses the
    threshold); ``submit*()`` routes requests to the owning shard's
    queue; ``step()`` runs one pipelined fleet tick; ``run()`` drains
    everything including the pipeline tail. One object, any mesh size —
    on a single device it degrades to exactly one shard (the engine's
    batching still applies)."""

    def __init__(self, devices=None, *, slots_per_device: int = 32,
                 lift_steps: int = 2,
                 shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
                 rebalance_every: int = 16,
                 rebalance_factor: float = 1.5,
                 policy_cache: policy.AutotuneCache | None = None,
                 runners: DistributedRunnerCache | None = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "devices=['cpu'] to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("FleetService needs at least one device")
        self.mesh = Mesh(self.devices, ("data",))
        self.shards = [
            ConnectivityService(slots=slots_per_device, device=d)
            for d in self.devices]
        self.engine = PipelinedTickEngine(self.shards)
        if runners is not None:
            # share built engines across service instances (the cache
            # is keyed by (rows, |V|), so it only makes sense for an
            # identical mesh)
            if list(runners.mesh.devices.flat) != self.devices:
                raise ValueError("shared runner cache was built for a "
                                 "different mesh")
            self.runners = runners
        else:
            self.runners = DistributedRunnerCache(self.mesh, ("data",),
                                                  lift_steps=lift_steps)
        self.shard_threshold = int(shard_threshold)
        self.rebalance_every = int(rebalance_every)
        self.rebalance_factor = float(rebalance_factor)
        self.policy_cache = policy_cache
        # sharded-tenant request plumbing (own queue + double buffer,
        # mirroring the engine's discipline)
        self._sharded: dict[str, ShardedTenant] = {}
        self._placement: dict[str, int] = {}   # packed tenant -> dev idx
        self._squeue: list[Request] = []
        # (req, host answer, CUDA event or None, rows)
        self._s_inflight: list = []
        self._uid = 0
        self.mesh_slo = SLORecorder()
        self.stats = {"ticks": 0, "admitted_packed": 0,
                      "admitted_sharded": 0, "sharded_resolves": 0,
                      "rebalances": 0, "migrations": 0, "promotions": 0}

    # -- admission ---------------------------------------------------------

    def tenants(self) -> list[str]:
        return sorted(list(self._placement) + list(self._sharded))

    def placement_of(self, name: str):
        """'mesh' for a sharded tenant, else the owning device index."""
        if name in self._sharded:
            return "mesh"
        if name in self._placement:
            return self._placement[name]
        raise KeyError(f"unknown tenant {name!r}; have {self.tenants()}")

    def admit(self, name: str, num_nodes: int, *,
              expected_edges: int = 0,
              degree_skew: float | None = None):
        """Place + create one tenant. Placement is incremental LPT over
        LIVE device loads — admitting tenants one by one lands each on
        the currently lightest device, consistent with what a full
        ``plan_placement`` replan would choose for the same arrival
        order (same work model, same tie-break)."""
        if name in self._sharded or name in self._placement:
            raise ValueError(f"tenant {name!r} already admitted")
        work = predicted_work(num_nodes, expected_edges,
                              degree_skew=degree_skew,
                              cache=self.policy_cache)
        if work >= self.shard_threshold:
            t = ShardedTenant(name, num_nodes, self.runners)
            self._sharded[name] = t
            self.stats["admitted_sharded"] += 1
            obs.count("fleet.admit.sharded")
            return t
        loads = self.device_loads()
        idx = min(range(len(self.shards)), key=lambda i: (loads[i], i))
        self.shards[idx].registry.create(name, num_nodes)
        self._placement[name] = idx
        self.stats["admitted_packed"] += 1
        obs.count("fleet.admit.packed")
        return self.shards[idx].registry.get(name)

    def drop(self, name: str) -> None:
        if name in self._sharded:
            del self._sharded[name]
            return
        idx = self._placement.pop(name)   # KeyError for unknown tenants
        self.shards[idx].registry.drop(name)

    # -- submission --------------------------------------------------------

    def submit(self, tenant: str, kind: str, payload=None) -> int:
        if tenant in self._sharded:
            return self._submit_sharded(tenant, kind, payload)
        idx = self._placement.get(tenant)
        if idx is None:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"have {self.tenants()}")
        return self.shards[idx].submit(tenant, kind, payload)

    def _submit_sharded(self, tenant: str, kind: str, payload) -> int:
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
        if kind in ("same_component", "component_size"):
            if payload is None:
                raise ValueError(f"kind {kind!r} requires a payload")
            payload = np.asarray(payload, np.int32)
            payload = payload.reshape(-1) if kind == "component_size" \
                else payload.reshape(-1, 2)
        elif kind in MUTATION_KINDS and payload is None:
            raise ValueError(f"kind {kind!r} requires a payload")
        self._uid += 1
        self._squeue.append(Request(self._uid, tenant, kind, payload,
                                    t_submit=time.perf_counter()))
        return self._uid

    def submit_insert(self, tenant: str, edges) -> int:
        return self.submit(tenant, "insert", edges)

    def submit_delete(self, tenant: str, edges) -> int:
        return self.submit(tenant, "delete", edges)

    def submit_query(self, tenant: str, kind: str, payload=None) -> int:
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; "
                             f"choose from {QUERY_KINDS}")
        return self.submit(tenant, kind, payload)

    # -- the fleet tick ----------------------------------------------------

    @property
    def pending(self) -> int:
        return (sum(len(s.queue) for s in self.shards)
                + len(self._squeue))

    @property
    def inflight(self) -> bool:
        return self.engine.inflight or bool(self._s_inflight)

    def step(self) -> list[Request]:
        """One fleet tick: the engine's pipelined pass over every
        per-device shard, plus the sharded-tenant dispatch/collect.
        Returns requests retired THIS tick (dispatched one tick ago)."""
        self.stats["ticks"] += 1
        retired = self.engine.tick()
        retired.extend(self._step_sharded())
        if self.rebalance_every > 0 \
                and self.stats["ticks"] % self.rebalance_every == 0:
            self._maybe_rebalance()
        return retired

    def run(self) -> list[Request]:
        """Drain every queue AND the pipeline tail."""
        finished: list[Request] = []
        while self.pending:
            finished.extend(self.step())
        while self.inflight:
            finished.extend(self.engine.flush())
            finished.extend(self._collect_sharded())
        return finished

    def _step_sharded(self) -> list[Request]:
        """Sharded-tenant phase of a tick: apply mutations (device-side
        log jits; retire immediately — the version is host-known), then
        dispatch queries on the lazily re-solved replicated labels;
        collect LAST tick's query results."""
        admitted, self._squeue = self._squeue, []
        retired: list[Request] = []
        current: list = []
        for r in admitted:
            t = self._sharded.get(r.tenant)
            try:
                if t is None:
                    raise KeyError(f"unknown sharded tenant {r.tenant!r}")
                if r.kind in MUTATION_KINDS:
                    with obs.span(f"fleet.sharded.{r.kind}",
                                  tenant=r.tenant):
                        r.result = getattr(t, r.kind)(r.payload)
                    r.done = True
                    if obs.enabled():
                        self.mesh_slo.record(
                            r.tenant, r.kind,
                            time.perf_counter() - r.t_submit)
                    retired.append(r)
                    continue
                before = t.resolves
                with obs.span(f"fleet.sharded.query.{r.kind}",
                              tenant=r.tenant):
                    labels = t.resolve()
                    if t.resolves != before:
                        self.stats["sharded_resolves"] += 1
                    if r.kind in ("same_component", "component_size"):
                        res = getattr(queries, r.kind)(labels, _to_device(
                            pad_rows_pow2(r.payload), labels.device))
                        rows = int(r.payload.shape[0])
                    elif r.kind == "count_components":
                        res, rows = queries.count_components(labels), -1
                    else:
                        res, rows = queries.component_histogram(labels), -2
                current.append((r, *_start_to_host(res), rows))
            except Exception as err:
                r.error = f"{type(err).__name__}: {err}"
                r.done = True
                retired.append(r)
        retired.extend(self._collect_sharded())
        self._s_inflight = current
        return retired

    def _collect_sharded(self) -> list[Request]:
        pending, self._s_inflight = self._s_inflight, []
        retired = []
        now = time.perf_counter()
        for r, res, event, rows in pending:
            try:
                if event is not None:
                    event.synchronize()
                host = queries.to_host(res)
                if rows == -1:
                    r.result = int(host)
                elif rows == -2:
                    r.result = host
                else:
                    r.result = host[:rows]
            except Exception as err:
                r.error = f"{type(err).__name__}: {err}"
            r.done = True
            if obs.enabled() and r.error is None:
                self.mesh_slo.record(r.tenant, r.kind, now - r.t_submit)
            retired.append(r)
        return retired

    # -- rebalancing -------------------------------------------------------

    def _live_spec(self, name: str, idx: int) -> TenantSpec:
        t = self.shards[idx].registry.get(name)
        return TenantSpec(name, t.num_nodes, t.num_edges,
                          degree_skew=None)

    def device_loads(self) -> list[int]:
        """Predicted work per device over LIVE (host-known) edge
        counts — no sync; this is what the rebalance trigger polls."""
        loads = [0] * len(self.shards)
        for name, idx in self._placement.items():
            s = self._live_spec(name, idx)
            loads[idx] += predicted_work(s.num_nodes, s.num_edges,
                                         cache=self.policy_cache)
        return loads

    def _maybe_rebalance(self) -> None:
        loads = self.device_loads()
        drift = imbalance(loads)
        if drift <= self.rebalance_factor:
            return
        with obs.span("fleet.rebalance", imbalance=round(drift, 3)) as sp:
            specs = [self._live_spec(n, i)
                     for n, i in self._placement.items()]
            plan = plan_placement(specs, len(self.shards),
                                  shard_threshold=self.shard_threshold,
                                  cache=self.policy_cache)
            moved = 0
            for name in plan.sharded:          # grew past the threshold
                if self._can_move(name):
                    self._promote(name)
                    moved += 1
            for name, dst in plan.device_of.items():
                if name not in self._placement:
                    continue                   # just promoted
                src = self._placement[name]
                if dst != src and self._can_move(name):
                    self._migrate(name, src, dst)
                    moved += 1
            sp.tag(moved=moved)
        self.stats["rebalances"] += 1

    def _can_move(self, name: str) -> bool:
        """A tenant with queued or in-flight requests on its shard
        stays put this round — migration drops and re-creates the
        session, which would orphan them."""
        src = self.shards[self._placement[name]]
        if any(r.tenant == name for r in src.queue):
            return False
        for shard, admitted, _ in self.engine._inflight:
            if shard is src and any(r.tenant == name for r in admitted):
                return False
        return True

    def _take_out(self, name: str):
        """Maintenance extraction: host view of the surviving edges
        (the ONE deliberate sync of the migration path), then drop the
        source session."""
        src_idx = self._placement.pop(name)
        t = self.shards[src_idx].registry.get(name)
        num_nodes, edges = t.num_nodes, t.edges()
        self.shards[src_idx].registry.drop(name)
        # the engine's cached label planes key on group MEMBERSHIP; a
        # departing tenant could later return under the same key with
        # labels the mutation phase never saw — drop the lot
        self.shards[src_idx]._fleet_label_planes = {}
        return num_nodes, edges

    def _migrate(self, name: str, src: int, dst: int) -> None:
        with obs.span("fleet.migrate", tenant=name, src=src, dst=dst):
            num_nodes, edges = self._take_out(name)
            self.shards[dst].registry.create(name, num_nodes)
            if edges.size:
                # re-ingests through the destination's pinned session:
                # the bulk insert policy-routes (rebuild for big sets)
                # and every array commits to the new device
                self.shards[dst].registry.insert(name, edges)
            self._placement[name] = dst
        self.stats["migrations"] += 1
        obs.count("fleet.migrations")

    def _promote(self, name: str) -> None:
        """Packed -> sharded class change when live work crosses the
        threshold: same extract-and-reingest as migration, landing in a
        mesh-wide tombstone log instead of a single-device session."""
        with obs.span("fleet.promote", tenant=name):
            num_nodes, edges = self._take_out(name)
            t = ShardedTenant(name, num_nodes, self.runners)
            if edges.size:
                t.insert(edges)
            self._sharded[name] = t
        self.stats["promotions"] += 1
        obs.count("fleet.promotions")

    # -- telemetry ---------------------------------------------------------

    def slo(self) -> SLORecorder:
        """EXACT global percentiles: per-device recorders + the mesh
        recorder merged by bucket-count summation (spec-checked), so
        the fleet's p99 is the p99 of the union request stream."""
        return merge_recorders([s.slo for s in self.shards]
                               + [self.mesh_slo])

    def slo_summary(self) -> dict:
        return self.slo().summary()

    def stats_summary(self) -> dict:
        out = dict(self.stats)
        out["engine"] = dict(self.engine.stats)
        out["runner_cache"] = dict(self.runners.stats)
        out["shards"] = [dict(s.stats) for s in self.shards]
        out["placement"] = {**{n: "mesh" for n in self._sharded},
                            **dict(self._placement)}
        return out

    def obs_summary(self) -> dict:
        return {"ticks": self.stats["ticks"],
                "latency": self.slo_summary(),
                "counters": dict(obs.tracer().counters),
                "fleet": {k: v for k, v in self.stats.items()
                          if k != "ticks"}}
