"""The built-in static backends of ``repro.api.backends``, one decorator
each: the wiring between the facade and the engines.

Counter semantics: backends with ``bit_exact_counters=True`` return
exact true-work ``WorkCounters`` (padding never billed, int64), equal
to the reference's int32 ones below 2^31. The per-round kernel backend
``pallas`` and ``hostloop`` return labels with zero or partial counters.

On a CUDA graph, ``pallas_fused`` and ``sampled_fused`` run the fused
segment-scan kernel, ``pallas`` the hook and multi_jump kernels, and
``batched`` (a fleet, through ``Solver.solve_batch``) the fused kernel's
batched entry; a kernel that does not build or launch raises.

The streaming engines ``incremental`` and ``dynamic`` also give the
``Solver`` its live state (``make_state``). ``distributed`` runs a
``mesh=`` session over the multi-shard engine (``core.distributed``):
on CUDA slots the fused kernel scans each slot's edges and the
multi_jump kernel compresses after each merge.
"""
from __future__ import annotations

import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.registry import (Capabilities, TraceEntry, VarInfo,
                                      register_backend, register_trace_spec)
from repro_torch.core import batch as batch_mod, cc as cc_mod
from repro_torch.core import distributed as dist_mod
from repro_torch.core.cc import CCResult
from repro_torch.core.incremental import DynamicCC, IncrementalCC
from repro_torch.core.rounds import WorkCounters
from repro_torch.graphs.device import DeviceGraph

__all__ = []            # nothing public; importing registers everything


# ---------------------------------------------------------------------------
# Single-graph torch-op variants (the paper's Fig. 5 ladder)
# ---------------------------------------------------------------------------

def _register_variant(method: str) -> None:
    @register_backend(
        method,
        Capabilities(static=True, bit_exact_counters=True,
                     spanning_forest=method in cc_mod.FOREST_METHODS))
    def _run(plan: ExecutionPlan, _method=method) -> CCResult:
        return cc_mod.solve_static(plan.graph, method=_method,
                                   num_segments=plan.num_segments,
                                   lift_steps=plan.lift_steps)


for _m in cc_mod.METHODS:       # soman multijump atomic_hook adaptive labelprop
    _register_variant(_m)


# ---------------------------------------------------------------------------
# Kernel backends
# ---------------------------------------------------------------------------

@register_backend("pallas_fused",
                  Capabilities(static=True, bit_exact_counters=True))
def _pallas_fused(plan: ExecutionPlan) -> CCResult:
    """The whole Fig. 4 segment scan in one launch of the fused kernel;
    labels and counters equal the torch-ops adaptive composition's."""
    return cc_mod.solve_static(plan.graph, method=cc_mod.FUSED_METHOD,
                               num_segments=plan.num_segments,
                               lift_steps=plan.lift_steps)


@register_backend("pallas", Capabilities(static=True,
                                         bit_exact_counters=False))
def _pallas_per_round(plan: ExecutionPlan) -> CCResult:
    """Per-round kernels: one hook launch per segment and cleanup round,
    one compress launch after each. Labels only: the counters are zeros
    by contract."""
    labels = cc_mod.solve_pallas(plan.graph,
                                 num_segments=plan.num_segments,
                                 lift_steps=plan.lift_steps)
    return CCResult(labels, WorkCounters.zeros(labels.device))


# ---------------------------------------------------------------------------
# Sampling-accelerated backends (k-out / Afforest-style)
# ---------------------------------------------------------------------------

def _run_sampled(plan: ExecutionPlan, fused: bool) -> CCResult:
    from repro_torch.core import sampled as sampled_mod
    res = sampled_mod.solve_sampled(plan.graph,
                                    num_segments=plan.num_segments,
                                    lift_steps=plan.lift_steps,
                                    fused=fused)
    # phase-split telemetry, read once after the solve
    plan.artifacts["sampled_stats"] = {k: int(v)
                                       for k, v in res.stats.items()}
    return CCResult(res.labels, res.work)


@register_backend("sampled",
                  Capabilities(static=True, bit_exact_counters=True,
                               spanning_forest=True))
def _sampled(plan: ExecutionPlan) -> CCResult:
    """The k-out sampling phase collapses the giant component, then the
    adaptive Fig. 4 scan covers the residue only. The sample-vs-residue
    work split lands in ``plan.artifacts["sampled_stats"]``."""
    return _run_sampled(plan, fused=False)


@register_backend("sampled_fused",
                  Capabilities(static=True, bit_exact_counters=True))
def _sampled_fused(plan: ExecutionPlan) -> CCResult:
    """``sampled`` with the residue scan on the fused kernel. The kernel
    records no forest edges, so this variant does not claim
    ``spanning_forest``."""
    return _run_sampled(plan, fused=True)


# ---------------------------------------------------------------------------
# Host-driven baseline loop (the GPU baseline's syncs)
# ---------------------------------------------------------------------------

@register_backend("hostloop", Capabilities(static=True, device_loop=False,
                                           bit_exact_counters=False))
def _hostloop(plan: ExecutionPlan) -> CCResult:
    """Soman/multijump under host control flow: one device round trip
    per convergence check. The raw loop stats land in
    ``plan.artifacts["hostloop_stats"]``."""
    g = plan.graph
    labels, stats = cc_mod.solve_hostloop(
        g.edges[:g.true_edges], g.num_nodes,
        method=plan.opts.get("hostloop_method", "soman"))
    plan.artifacts["hostloop_stats"] = stats
    work = WorkCounters.zeros(g.device).add(
        hook_rounds=stats["hook_rounds"], jump_sweeps=stats["jump_sweeps"],
        sync_rounds=stats["sync_rounds"])
    return CCResult(torch.from_numpy(labels).to(g.device), work)


# ---------------------------------------------------------------------------
# Batched engine (many graphs, one kernel launch per shape bucket scan)
# ---------------------------------------------------------------------------

@register_backend("batched", Capabilities(static=True, batched=True,
                                          bit_exact_counters=True))
def _batched(plan: ExecutionPlan) -> list[CCResult]:
    """Shape-bucketed engine; one ``CCResult`` per input graph, labels
    and counters equal to the reference's ``solve_batched``."""
    return batch_mod.solve_batched(plan.graphs,
                                   num_segments=plan.num_segments,
                                   lift_steps=plan.lift_steps,
                                   device=plan.opts.get("device"))


# ---------------------------------------------------------------------------
# Streaming engines (live state via make_state)
# ---------------------------------------------------------------------------

def _run_streaming(backend, plan: ExecutionPlan) -> CCResult:
    """One-shot run of a streaming engine: absorb the plan's graph into
    fresh state on its device."""
    state = backend.make_state(plan.num_nodes, lift_steps=plan.lift_steps,
                               device=plan.graph.device)
    state.insert_graph(plan.graph)
    return CCResult(state.labels,
                    WorkCounters.zeros(state.device).add(**state.work))


@register_backend("incremental",
                  Capabilities(static=True, streaming=True,
                               bit_exact_counters=True))
class _Incremental:
    """Insert-only streaming engine."""

    def make_state(self, num_nodes: int, *, lift_steps: int = 2,
                   scan_method: str | None = None,
                   device=None) -> IncrementalCC:
        return IncrementalCC(num_nodes, lift_steps=lift_steps, device=device)

    def run(self, plan: ExecutionPlan) -> CCResult:
        return _run_streaming(self, plan)


@register_backend("dynamic",
                  Capabilities(static=True, streaming=True, deletions=True,
                               bit_exact_counters=True,
                               maintained_forest=True))
class _Dynamic:
    """Fully-dynamic engine: tombstone log + scoped recompute.
    ``Solver`` sessions get their live state here."""

    def make_state(self, num_nodes: int, *, lift_steps: int = 2,
                   scan_method: str | None = None,
                   device=None) -> DynamicCC:
        return DynamicCC(num_nodes, lift_steps=lift_steps,
                         scan_method=scan_method or "jnp", device=device)

    def run(self, plan: ExecutionPlan) -> CCResult:
        return _run_streaming(self, plan)


# ---------------------------------------------------------------------------
# Multi-shard engine (spatial segmentation across a mesh)
# ---------------------------------------------------------------------------

@register_backend("distributed",
                  Capabilities(static=True, sharded=True,
                               bit_exact_counters=False))
def _distributed(plan: ExecutionPlan) -> CCResult:
    """The multi-shard engine over the plan's mesh. Labels only: the
    per-slot counters are not folded, so the counters are zeros. The
    merge rounds run land in ``plan.artifacts["rounds"]``."""
    mesh = plan.opts.get("mesh")
    if mesh is None:
        raise ValueError("the distributed backend needs a mesh "
                         "(Solver.open(graph, mesh=...))")
    axis_names = plan.opts.get("axis_names", ("data",))
    graph = plan.graph.shard(mesh, axis_names)
    fn = dist_mod.build_distributed_cc(graph, mesh, axis_names=axis_names,
                                       lift_steps=plan.lift_steps)
    labels = fn(graph)
    plan.artifacts["rounds"] = fn.last_rounds
    return CCResult(labels, WorkCounters.zeros(labels.device))


# ---------------------------------------------------------------------------
# Trace specs (consumed by repro_torch.analysis)
# ---------------------------------------------------------------------------
# Each spec builds a backend's program over ``meta`` example arguments at
# a shape bucket: ``repro_torch.analysis`` runs it on drawn inputs and
# holds the record to the contracts (transfer-freedom on tick paths,
# int32 range safety at scale-tier shapes, pow2 bucketing, the padding
# mask). A true count is a Python int, as the port's ``DeviceGraph``
# holds it. Engine state an entry needs before the program it names (the
# log a delete tombstones, the forest an absorb extends) is built under
# ``graph_utils.untraced``, from the entry's own drawn edges.

def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _true(rows: int) -> int:
    """The true count of a pow2 bucket three quarters full."""
    return rows - rows // 4


def _ids(v: int, padded: bool = False):
    return VarInfo(range=(0, v - 1), padded=padded)


def _count(n: int):
    return VarInfo(range=(0, n), mask=True)


def _graph_fn_build(v: int, e: int, run):
    """The build of every entry of shape fn(edges, true_edges)."""
    def fn(edges, true_edges):
        return run(DeviceGraph.from_edges(edges, v, true_edges=true_edges))
    return fn, (_meta((e, 2)), _true(e)), [_ids(v, True), _count(e)]


def _static_solve_entry(method: str):

    def build(v, e, _method=method):
        return _graph_fn_build(
            v, e, lambda g: cc_mod.solve_static(g, method=_method))
    return TraceEntry(name=f"backend.{method}", build=build, backend=method)


@register_trace_spec("static")
def _static_specs():
    return [_static_solve_entry(m)
            for m in cc_mod.METHODS + (cc_mod.FUSED_METHOD,)]


@register_trace_spec("sampled")
def _sampled_specs():
    from repro_torch.core import rounds, sampled as sampled_mod
    from repro_torch.core.segmentation import adaptive_num_segments

    def build_sample(v, e):
        def fn(edges, true_edges):
            return sampled_mod._sample_phase(
                edges, true_edges, v, k=sampled_mod.SAMPLE_K,
                sample_rounds=sampled_mod.SAMPLE_ROUNDS, lift_steps=2)
        return (fn, (_meta((e, 2)), _true(e)), [_ids(v, True), _count(e)])

    def residue_build(v, e, fused):
        # parents and work start fresh; pi arrives as the sampling
        # phase's labels
        def fn(edges, true_edges, pi):
            dev = edges.device
            return sampled_mod._residue_scan(
                edges, true_edges, pi, rounds.empty_forest(v, dev),
                WorkCounters.zeros(dev), num_nodes=v,
                num_segments=adaptive_num_segments(e, v), lift_steps=2,
                fused=fused)
        return (fn, (_meta((e, 2)), _true(e), _meta((v,))),
                [_ids(v, True), _count(e), _ids(v)])

    return [TraceEntry(name="backend.sampled.sample_phase",
                       build=build_sample, backend="sampled"),
            TraceEntry(name="backend.sampled.residue",
                       build=lambda v, e: residue_build(v, e, False),
                       backend="sampled"),
            TraceEntry(name="backend.sampled_fused.residue",
                       build=lambda v, e: residue_build(v, e, True),
                       backend="sampled_fused")]


@register_trace_spec("pallas")
def _pallas_specs():

    def build(v, e):
        return _graph_fn_build(v, e, lambda g: cc_mod.solve_pallas(g))
    return [TraceEntry(name="backend.pallas", build=build,
                       backend="pallas")]


@register_trace_spec("hostloop")
def _hostloop_specs():
    # the hostloop backend is CONTRACTED to sync (device_loop=False);
    # its per-step device programs are each their own entry without the
    # transfer_free contract
    from repro_torch.core.rounds import compress, hook_edges, jump_once

    def build_hook(v, e):
        def fn(pi, edges):
            return hook_edges(pi, edges, lift_steps=0)
        return (fn, (_meta((v,)), _meta((e, 2))), [_ids(v), _ids(v, True)])

    def build_jump(v, e):
        return jump_once, (_meta((v,)),), [_ids(v)]

    def build_compress(v, e):
        def fn(pi):
            return compress(pi, WorkCounters.zeros(pi.device))
        return fn, (_meta((v,)),), [_ids(v)]

    bucketed = frozenset({"bucketed"})
    return [TraceEntry("backend.hostloop.hook", build_hook, bucketed,
                       backend="hostloop"),
            TraceEntry("backend.hostloop.jump", build_jump, bucketed,
                       backend="hostloop"),
            TraceEntry("backend.hostloop.compress", build_compress,
                       bucketed, backend="hostloop")]


@register_trace_spec("batched")
def _batched_specs():

    def build(v, e, batch=4):
        per = max(e // batch, 8)

        def fn(edges, true_edges, true_nodes):
            return batch_mod.solve_bucket(edges, true_edges, true_nodes, v)
        return (fn, (_meta((batch, per, 2)), _meta((batch,)),
                     _meta((batch,))),
                [_ids(v, True), _count(per), _count(v)])
    return [TraceEntry(name="backend.batched", build=build,
                       backend="batched")]


def _absorb_build(v: int, e: int, engine):
    """fn(pi, new_edges, true_count): absorb one batch into an engine
    holding the labels ``pi`` (adopted under ``untraced``)."""
    from repro_torch.analysis.graph_utils import untraced

    def fn(pi, new_edges, true_count):
        with untraced():
            state = engine(v, device=pi.device)
            state.adopt(pi)
        return state.insert_graph(
            DeviceGraph.from_edges(new_edges, v, true_edges=true_count))
    return (fn, (_meta((v,)), _meta((e, 2)), _true(e)),
            [_ids(v), _ids(v, True), _count(e)])


@register_trace_spec("incremental")
def _incremental_specs():
    return [TraceEntry(name="backend.incremental.absorb",
                       build=lambda v, e: _absorb_build(v, e, IncrementalCC),
                       backend="incremental")]


def _delete_build(v: int, e: int, route: str):
    """fn(edges, d_true): a delete tick over a log holding ``edges``
    (inserted under ``untraced``) of its first ``d`` rows, ``d_true`` of
    them true: the scoped recompute on torch ops (``jnp``) or the fused
    kernel, or the tree-aware route (``forest``)."""
    from repro_torch.analysis.graph_utils import untraced
    d = max(e // 4, 8)

    def fn(edges, d_true):
        with untraced():
            state = DynamicCC(v, scan_method="jnp" if route == "forest"
                              else route, device=edges.device)
            state.insert_graph(DeviceGraph.from_edges(edges, v))
            dels = DeviceGraph.from_edges(edges[:d], v, true_edges=d_true)
        if route == "forest":
            return state.delete_graph_forest(dels)
        return state.delete_graph(dels)
    return fn, (_meta((e, 2)), _true(d)), [_ids(v), _count(d)]


def _absorb_forest_build(v: int, e: int):
    """fn(edges, new_edges, true_count): an absorb that extends the
    maintained forest of a log holding ``edges`` (under ``untraced``)."""
    from repro_torch.analysis.graph_utils import untraced

    def fn(edges, new_edges, true_count):
        with untraced():
            state = DynamicCC(v, device=edges.device)
            state.insert_graph(DeviceGraph.from_edges(edges, v))
        return state.insert_graph(
            DeviceGraph.from_edges(new_edges, v, true_edges=true_count))
    return (fn, (_meta((e, 2)), _meta((e, 2)), _true(e)),
            [_ids(v), _ids(v, True), _count(e)])


@register_trace_spec("dynamic")
def _dynamic_specs():
    return [TraceEntry(name="backend.dynamic.absorb",
                       build=lambda v, e: _absorb_build(v, e, DynamicCC),
                       backend="dynamic"),
            TraceEntry(name="backend.dynamic.absorb_forest",
                       build=_absorb_forest_build, backend="dynamic"),
            TraceEntry(name="backend.dynamic.delete",
                       build=lambda v, e: _delete_build(v, e, "jnp"),
                       backend="dynamic"),
            TraceEntry(name="backend.dynamic.delete_fused",
                       build=lambda v, e: _delete_build(v, e,
                                                        "pallas_fused"),
                       backend="dynamic"),
            TraceEntry(name="backend.dynamic.delete_forest",
                       build=lambda v, e: _delete_build(v, e, "forest"),
                       backend="dynamic")]


@register_trace_spec("distributed")
def _distributed_specs():
    from repro_torch.analysis.graph_utils import untraced
    from repro_torch.launch.mesh import make_mesh

    def build(v, e):
        def fn(edges):
            with untraced():
                mesh = make_mesh(1, device=edges.device)
                call = dist_mod.build_distributed_cc(
                    DeviceGraph.from_edges(edges, v).shard(mesh), mesh)
            return call.on_edges(edges)
        return fn, (_meta((e, 2)),), [_ids(v, True)]
    return [TraceEntry(name="backend.distributed", build=build,
                       backend="distributed")]
