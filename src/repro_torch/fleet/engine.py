"""Pipelined tick engine: dispatch everything, wait once, one tick late
(DESIGN.md §15), the port of ``repro.fleet.engine``.

The single-device ``ConnectivityService`` tick is synchronous per query
group: every (tenant, kind) microbatch pays a registry cache check (a
version read back), a dispatch and a device-to-host copy before the
next group dispatches. This engine splits a tick into three phases
that never wait on the device between dispatches:

  1. **mutation phase**: each shard's coalesced insert/delete calls
     (``ConnectivityService._run_mutations``, reused as is: the
     per-device shell IS the service);
  2. **query phase**: queries batch ACROSS tenants per shard: every
     same-|V| tenant group on a device answers all its pairs in one
     call over a cached stacked label plane [T, V] (``_label_plane``,
     patched row by row only where a member mutated), so a shard pays
     about one dispatch per (kind, |V|) instead of one per tenant. The
     query rows go up through pinned memory without waiting, and each
     group's answers start back to pinned host memory at once, behind
     an event;
  3. **collect phase**: LAST tick's pending answers are read once their
     events have completed, while THIS tick's work runs on the devices
     (double buffering: requests retire exactly one tick after
     dispatch).

One CUDA stream orders everything, so a ``.cpu()`` issued at collect
would queue behind this tick's kernels and lose the overlap; the copy
issued at dispatch, waited on through its event at collect, keeps it.

The reference's steady-state mutation tick performs no host transfer at
all (its ``jax.transfer_guard`` contract). The port's does: its dynamic
engine reads loop conditions back, and the service reads a tenant's
version at query time. The fleet tick's read backs are counted on the
card (``PERF.md`` §5), not claimed to be zero.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.connectivity import queries
from repro_torch.connectivity.queries import _vertex_ids
from repro_torch.connectivity.service import (MUTATION_KINDS,
                                              ConnectivityService)
from repro_torch.graphs.device import next_pow2
from repro_torch.obs import trace as obs

# kinds the cross-tenant batcher stacks (per-row payloads); the scalar
# kinds dispatch one small call per tenant instead
BATCHED_KINDS = ("same_component", "component_size")

_MIN_QROWS = 8
_INT32_LIMIT = 2**31


def _batched_query(plane: torch.Tensor, batch: torch.Tensor, kind: str
                   ) -> torch.Tensor:
    """ONE call answering a query kind for a whole same-|V| tenant
    group: ``plane`` is the stacked label plane [T, V], ``batch`` the
    padded per-tenant rows ([T, Q, 2] pairs or [T, Q] vertices). Bit
    for bit the per-tenant ``queries`` functions, row by row: ids are
    read as they read them, and the sizes come from one census over
    the plane's labels offset by ``t * V`` (disjoint per tenant)."""
    t, v = plane.shape
    ids = _vertex_ids(batch, v, plane.device)
    if kind == "same_component":
        return torch.gather(plane, 1, ids[..., 0]) \
            == torch.gather(plane, 1, ids[..., 1])
    offsets = torch.arange(t, dtype=torch.int32, device=plane.device) * v
    census = queries.component_census(
        (plane + offsets[:, None]).reshape(-1))
    return census[torch.gather(plane, 1, ids).long()
                  + offsets[:, None].long()]


def _mark_labels_dirty(shard, tenants) -> None:
    """Mark these tenants' rows of every cached ``_label_plane`` stale
    (called by the mutation phase: a mutated session replaces its label
    tensor)."""
    dirty = getattr(shard, "_fleet_dirty_labels", None)
    if dirty is None:
        dirty = shard._fleet_dirty_labels = set()
    dirty.update(tenants)


def _label_plane(shard, v: int, group) -> torch.Tensor:
    """The stacked [T, V] label plane of one same-|V| tenant group,
    CACHED on the shard across ticks, so that a steady-state dispatch
    costs O(1) host work, not a T-tensor stack. It is built once (one
    ``torch.stack``) and afterwards patched in place, one row per
    mutated member (``plane[i] = labels``). In place is safe: every
    answer computed from the plane is its own tensor, made earlier on
    the same stream, and no view of the plane leaves this engine.
    Membership changes show in the cache key (the sorted tenant tuple;
    migration also drops the source shard's planes)."""
    key = (v, tuple(g[0] for g in group))
    cache = getattr(shard, "_fleet_label_planes", None)
    if cache is None:
        cache = shard._fleet_label_planes = {}
    dirty = getattr(shard, "_fleet_dirty_labels", ())
    plane = cache.get(key)
    if plane is None:
        if len(group) * v >= _INT32_LIMIT:
            raise ValueError(f"T * V = {len(group) * v} does not fit "
                             "int32: split the tenant group")
        plane = torch.stack([t.labels for _, t, _ in group])
    elif dirty:
        for i, name in enumerate(key[1]):
            if name in dirty:
                plane[i] = group[i][1].labels
    else:
        return plane
    cache[key] = plane
    if dirty:
        shard._fleet_dirty_labels -= set(key[1])
    return plane


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows to ``device`` without waiting on it: through pinned
    memory on CUDA (a pageable copy synchronises the stream)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _start_to_host(result: torch.Tensor):
    """Start the device-to-host copy of a pending answer: on CUDA into
    pinned memory, behind an event the collect phase waits on. Returns
    (host tensor, event or None)."""
    if result.device.type != "cuda":
        return result, None
    host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    host.copy_(result, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(result.device))
    return host, event


@dataclasses.dataclass
class PendingGroup:
    """One dispatched query group awaiting collect: either a batched
    (kind, |V|) tenant stack or a single tenant's scalar-kind call."""

    kind: str
    tenants: list                    # tenant names, stack order
    reqs: list                       # list[list[Request]] per tenant
    rows: list                       # list[list[int]] rows per request
    result: Any                      # host tensor, maybe still arriving
    batched: bool = True
    event: Any = None                # CUDA event: the copy has landed


def dispatch_queries(shard: ConnectivityService, admitted
                     ) -> list[PendingGroup]:
    """Phase-2 dispatch for one shard: group, stack, launch. Returns
    pending groups whose answers are still on their way to the host."""
    by_kind: dict[str, dict[str, list]] = {}
    for r in admitted:
        by_kind.setdefault(r.kind, {}).setdefault(r.tenant, []).append(r)
    pending: list[PendingGroup] = []
    for kind, tenants in by_kind.items():
        if kind in BATCHED_KINDS:
            pending.extend(_dispatch_batched(shard, kind, tenants))
        else:
            pending.extend(_dispatch_scalar(shard, kind, tenants))
    return pending


def _fail_group(shard, reqs, err) -> None:
    for r in reqs:
        shard._fail(r, err)


def _dispatch_batched(shard, kind, tenants) -> list[PendingGroup]:
    # sub-group by |V|: the stacked call needs one label shape
    by_v: dict[int, list] = {}
    for tenant, reqs in sorted(tenants.items()):
        try:
            t = shard.registry.get(tenant)
        except Exception as err:
            _fail_group(shard, reqs, err)
            continue
        by_v.setdefault(t.num_nodes, []).append((tenant, t, reqs))
    out = []
    for v, group in by_v.items():
        names = [g[0] for g in group]
        with obs.span(f"fleet.query.{kind}", tenants=len(group),
                      num_nodes=v) as sp:
            try:
                flats, rows = [], []
                for _, _, reqs in group:
                    if len(reqs) == 1:      # no concat copy on the
                        f = np.asarray(reqs[0].payload)   # common path
                        flats.append(f)
                        rows.append([f.shape[0]])
                        continue
                    parts = [np.asarray(r.payload) for r in reqs]
                    flats.append(np.concatenate(parts, axis=0))
                    rows.append([p.shape[0] for p in parts])
                qb = next_pow2(max(_MIN_QROWS,
                                   max(f.shape[0] for f in flats)))
                if all(f.shape[0] == qb for f in flats):
                    stacked = np.stack(flats)   # uniform: no pad fill
                else:
                    shape = (len(group), qb) + flats[0].shape[1:]
                    stacked = np.zeros(shape, np.int32)
                    for i, f in enumerate(flats):
                        stacked[i, : f.shape[0]] = f
                # the query phase's one host-to-device copy a group
                batch = _to_device(stacked, shard.device)
                labels = _label_plane(shard, v, group)
                result, event = _start_to_host(
                    _batched_query(labels, batch, kind))
                sp.tag(rows=int(sum(f.shape[0] for f in flats)))
            except Exception as err:      # fail the group, not the tick
                for _, _, reqs in group:
                    _fail_group(shard, reqs, err)
                sp.tag(failed=sum(len(g[2]) for g in group))
                continue
        shard.stats["query_calls"] += 1
        out.append(PendingGroup(kind=kind, tenants=names,
                                reqs=[g[2] for g in group], rows=rows,
                                result=result, event=event))
    return out


def _dispatch_scalar(shard, kind, tenants) -> list[PendingGroup]:
    out = []
    for tenant, reqs in sorted(tenants.items()):
        with obs.span(f"fleet.query.{kind}", tenant=tenant) as sp:
            try:
                labels = shard.registry.get(tenant).labels
                result, event = _start_to_host(getattr(
                    queries, "count_components"
                    if kind == "count_components"
                    else "component_histogram")(labels))
            except Exception as err:
                _fail_group(shard, reqs, err)
                sp.tag(failed=len(reqs))
                continue
        shard.stats["query_calls"] += 1
        out.append(PendingGroup(kind=kind, tenants=[tenant],
                                reqs=[reqs], rows=[[0] * len(reqs)],
                                result=result, batched=False,
                                event=event))
    return out


def collect_group(shard: ConnectivityService, group: PendingGroup
                  ) -> None:
    """Phase-3 materialisation of one pending group: wait for its copy,
    slice the answers, retire and record the end-to-end SLO."""
    record = obs.enabled()
    try:
        if group.event is not None:
            group.event.synchronize()
        host = queries.to_host(group.result)
    except Exception as err:
        for reqs in group.reqs:
            _fail_group(shard, reqs, err)
        return
    now = time.perf_counter()
    for i, (tenant, reqs, rows) in enumerate(
            zip(group.tenants, group.reqs, group.rows)):
        off = 0
        for r, nrows in zip(reqs, rows):
            if group.batched:
                r.result = host[i, off: off + nrows]
                off += nrows
                shard.stats["pairs_answered"] += nrows
            elif group.kind == "count_components":
                r.result = int(host)
            else:
                r.result = host
            r.done = True
            shard.stats["queries_served"] += 1
            shard.stats["recomputes_avoided"] += 1
            if record:
                # end to end: collect minus submit (queue wait,
                # dispatch, device time and the one-tick pipeline delay)
                shard.slo.record(tenant, group.kind, now - r.t_submit)


class PipelinedTickEngine:
    """Double-buffered tick loop over per-device shards.

    ``tick()`` dispatches the mutation and query phases of EVERY shard
    before waiting on anything, then collects the PREVIOUS tick's
    pending answers, so that the host's waits overlap the devices
    running the current tick. ``flush()`` drains the last in-flight tick
    when the queues run dry."""

    def __init__(self, shards: list):
        self.shards = list(shards)
        self._inflight: list = []     # (shard, admitted, groups)
        self.stats = {"ticks": 0, "batched_dispatches": 0,
                      "collects": 0}

    @property
    def inflight(self) -> bool:
        return bool(self._inflight)

    def tick(self) -> list:
        """One pipelined tick; returns the requests RETIRED this tick
        (admitted one tick earlier: the pipeline's latency price)."""
        staged = []
        for shard in self.shards:
            admitted = shard._pop_admitted()
            if admitted:
                shard.stats["ticks"] += 1
            staged.append((shard, admitted))
        if any(adm for _, adm in staged):
            self.stats["ticks"] += 1
        with obs.span("fleet.tick", step=self.stats["ticks"],
                      admitted=sum(len(a) for _, a in staged)):
            # phase 1: every shard's mutations, back to back
            for shard, admitted in staged:
                for kind in MUTATION_KINDS:
                    batch = [r for r in admitted if r.kind == kind]
                    if batch:
                        _mark_labels_dirty(
                            shard, (r.tenant for r in batch))
                        shard._run_mutations(kind, batch)
            # phase 2: the query calls, answers sent off to the host
            current = []
            for shard, admitted in staged:
                qreqs = [r for r in admitted
                         if r.kind not in MUTATION_KINDS and not r.done]
                groups = dispatch_queries(shard, qreqs)
                self.stats["batched_dispatches"] += sum(
                    1 for g in groups if g.batched)
                if admitted:
                    current.append((shard, admitted, groups))
            # phase 3: collect LAST tick while this one runs
            retired = self._collect()
            self._inflight = current
        return retired

    def _collect(self) -> list:
        retired = []
        for shard, admitted, groups in self._inflight:
            for g in groups:
                collect_group(shard, g)
            self.stats["collects"] += len(groups)
            retired.extend(admitted)
        self._inflight = []
        return retired

    def flush(self) -> list:
        """Drain the in-flight tick (the pipeline's tail)."""
        return self._collect()
