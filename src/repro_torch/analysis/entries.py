"""Non-backend traceable entries and the entry collector, the port of
``repro.analysis.entries``.

``repro_torch.api.backends`` registers one trace spec per execution
backend; this module adds the surfaces the serving layer runs that are
NOT a backend's own program:

* **the service tick** — what ``ConnectivityService._run_mutations``
  runs per tenant per tick: coalesce two payloads with
  ``DeviceGraph.concat``, bucket with ``pad_pow2``, and absorb them
  (inserts) or tombstone them and recompute the affected components
  (deletes, on the scoped route or the tree-aware one). The tick is the
  hottest transfer-free contract in the repo: a host sync here blocks
  every tenant in the slot;
* **the instrumented tick** — the same with ``repro_torch.obs``'s
  device ``Metrics`` folded in (``record_mutation``);
* **the query kernels** — ``repro_torch.connectivity.queries``,
  contracted transfer-free (results are materialized only through the
  audited ``to_host`` sink, *after* the kernel);
* **the fleet's batched queries** — ``repro_torch.fleet.engine``'s one
  call per (kind, |V|) tenant group over a stacked label plane.

The engine state a tick acts on (a log holding the graph, labels to
absorb into) is built under ``graph_utils.untraced`` from the entry's
own drawn inputs. ``all_entries()`` is the one discovery point the
runner and the tests use.
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import (TraceEntry, VarInfo,
                                      register_trace_spec, trace_entries)

_TF = frozenset({"transfer_free", "bucketed"})


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _ids(v: int, padded: bool = False) -> VarInfo:
    return VarInfo(range=(0, v - 1), padded=padded)


def _coalesced(parts, v: int):
    """Two payloads as the service stages them: one concat, pow2 rows."""
    from repro_torch.graphs.device import DeviceGraph
    return DeviceGraph.concat(
        [DeviceGraph.from_edges(p, v) for p in parts]).pad_pow2()


def _tick_specs(prefix: str, metrics: bool) -> list:
    from repro_torch.analysis.graph_utils import untraced
    from repro_torch.core.incremental import DynamicCC
    from repro_torch.graphs.device import DeviceGraph

    def state_over(pi=None, edges=None, v=0):
        with untraced():
            s = DynamicCC(v, device=(pi if pi is not None else edges).device)
            if pi is not None:
                s.adopt(pi)
            else:
                s.insert_graph(DeviceGraph.from_edges(edges, v))
            if metrics:
                s.enable_metrics()
        return s

    def build_insert_tick(v, e):
        half = max(e // 2, 8)

        def fn(pi, edges_a, edges_b):
            s = state_over(pi=pi, v=v)
            s.insert_graph(_coalesced((edges_a, edges_b), v))
            return (s.labels, s.version_device) + (
                (s.metrics,) if metrics else ())
        return (fn, (_meta((v,)), _meta((half, 2)), _meta((half, 2))),
                [_ids(v), _ids(v), _ids(v)])

    def build_delete_tick(v, e, forest):
        d = max(e // 8, 8)

        def fn(edges):
            s = state_over(edges=edges, v=v)
            with untraced():          # two payloads of logged edges
                parts = (edges[:d], edges[d:2 * d])
            dels = _coalesced(parts, v)
            if forest:
                s.delete_graph_forest(dels)
            else:
                s.delete_graph(dels)
            return (s.labels, s.version_device) + (
                (s.metrics,) if metrics else ())
        return fn, (_meta((e, 2)),), [_ids(v)]

    entries = [
        TraceEntry(f"{prefix}.tick.insert", build_insert_tick, _TF),
        TraceEntry(f"{prefix}.tick.delete",
                   lambda v, e: build_delete_tick(v, e, False), _TF)]
    if not metrics:
        entries.append(TraceEntry(
            f"{prefix}.tick.delete_forest",
            lambda v, e: build_delete_tick(v, e, True), _TF))
    return entries


@register_trace_spec("service")
def _service_specs():
    return _tick_specs("service", metrics=False)


@register_trace_spec("obs")
def _obs_specs():
    """The INSTRUMENTED service tick: carrying the ``repro_torch.obs``
    device ``Metrics`` through the mutations keeps the steady-state tick
    transfer-free. If the metrics update ever grows a host sync, the
    ``transfer`` pass flags it here."""
    return _tick_specs("obs", metrics=True)


@register_trace_spec("queries")
def _query_specs():
    from repro_torch.connectivity import queries as q

    def build_same_component(v, e):
        nq = max(e // 16, 8)
        return (q.same_component, (_meta((v,)), _meta((nq, 2))),
                [_ids(v), _ids(v, True)])

    def build_component_size(v, e):
        nq = max(e // 16, 8)
        return (q.component_size, (_meta((v,)), _meta((nq,))),
                [_ids(v), _ids(v, True)])

    def build_count_components(v, e):
        return q.count_components, (_meta((v,)),), [_ids(v)]

    def build_component_histogram(v, e):
        return q.component_histogram, (_meta((v,)),), [_ids(v)]

    def build_forest_stats(v, e):
        # parents rows carry -1 sentinels for roots, hence the -1 floor
        return (q.spanning_forest_stats, (_meta((v,)), _meta((v, 2))),
                [_ids(v), VarInfo(range=(-1, v - 1))])

    return [
        TraceEntry("queries.same_component", build_same_component, _TF),
        TraceEntry("queries.component_size", build_component_size, _TF),
        TraceEntry("queries.count_components", build_count_components,
                   _TF),
        TraceEntry("queries.component_histogram",
                   build_component_histogram, _TF),
        TraceEntry("queries.spanning_forest_stats", build_forest_stats,
                   _TF),
    ]


@register_trace_spec("fleet")
def _fleet_specs():
    """The fleet's pipelined query phase: the cross-tenant BATCHED
    queries ``repro_torch.fleet.engine`` dispatches, one call answering
    a query kind for a whole same-|V| tenant group. The mutation phase
    is the service's (``service.tick.*``). The 4-tenant stack mirrors the
    engine's (kind, |V|) grouping; the rows are pow2-padded
    (``padded=True``) as its dispatch stages them."""
    from repro_torch.fleet.engine import _batched_query

    n_tenants = 4

    def build(kind, rows):
        def b(v, e):
            qb = max(e // 16, 8)

            def fn(labels, batch):
                return _batched_query(labels, batch, kind)
            return (fn, (_meta((n_tenants, v)),
                         _meta((n_tenants, qb) + rows)),
                    [_ids(v), _ids(v, True)])
        return b

    return [TraceEntry("fleet.query.same_component",
                       build("same_component", (2,)), _TF),
            TraceEntry("fleet.query.component_size",
                       build("component_size", ()), _TF)]


def all_entries() -> list:
    """Every registered ``TraceEntry`` (backends + service + queries +
    fleet), importing the spec-bearing modules for their side
    effects."""
    import repro_torch.api.backends  # noqa: F401  — registers backend specs
    return trace_entries()
