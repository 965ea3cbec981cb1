"""The built-in static backends of ``repro.api.backends``, one decorator
each: the wiring between the facade and the engines.

Counter semantics: backends with ``bit_exact_counters=True`` return
exact true-work ``WorkCounters`` (padding never billed), equal to the
reference's. The per-round kernel backend ``pallas`` and ``hostloop``
return labels with zero or partial counters.

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
from repro_torch.api.registry import Capabilities, register_backend
from repro_torch.core import batch as batch_mod, cc as cc_mod
from repro_torch.core import distributed as dist_mod
from repro_torch.core.cc import CCResult
from repro_torch.core.incremental import DynamicCC, IncrementalCC
from repro_torch.core.rounds import WorkCounters

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
