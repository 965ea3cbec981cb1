"""Adaptive work-efficient Connected Components — the paper's core, on
PyTorch (the static half of ``repro.core.cc``).

The four variants of the paper's Fig. 5, plus label propagation and the
two kernel backends:

  * ``soman``        — Soman et al. baseline: single-level hook rounds +
                       single-level Jump sweeps, a convergence check
                       after every sweep (billed as a host sync each).
  * ``multijump``    — + Multi-Jump: the whole Compress phase fused.
  * ``atomic_hook``  — + Atomic-Hook: a root-chasing hook pass over the
                       whole edge list, fused with compress.
  * ``adaptive``     — + adaptive segmentation: s = 2|E|/|V| segments,
                       each hooked and then fully compressed (Fig. 4).
  * ``labelprop``    — label propagation (``repro_torch.core.labelprop``).
  * ``pallas_fused`` — ``adaptive`` over the fused segment-scan kernel:
                       one launch per scan and per cleanup round.
  * ``solve_pallas`` — ``adaptive`` over the per-round hook and
                       multi_jump kernels (backend ``pallas``).
  * ``sampled``, ``sampled_fused`` — the k-out sampling engines
                       (``repro_torch.core.sampled``).

``solve_forest`` runs the hook-round variants with recording ops
(``rounds.forest_round_ops``) and returns the spanning forest beside the
labels.

The backend names are the reference's, so that code keyed on them reads
the same in both packages. Every variant returns canonical labels
(``labels[v] == min vertex id of v's component``) and ``WorkCounters``
equal to the reference's field by field wherever its int32 counters do
not wrap (the port counts in int64); work bills TRUE (unpadded) edges.
The reference's jitted while-loops are host loops here, and
``sync_rounds`` still bills what the reference bills (for example 1 for
a method that is a single jitted program), not the host reads this
eager port makes.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(or a graph that already lives on the CPU); with no CUDA and no device
they raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rounds
from repro_torch.core.rounds import (WorkCounters, compress, hook_edges,
                                     jump_once)
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import as_device_graph, resolve_device

_MAX_ROUNDS = rounds.MAX_ROUNDS   # outer hook-round fuel

METHODS = ("soman", "multijump", "atomic_hook", "adaptive", "labelprop")
FUSED_METHOD = "pallas_fused"
# the k-out sampling engines: the sample phase collapses the giant
# component, the adaptive scan covers the residue only
SAMPLED_METHODS = ("sampled", "sampled_fused")
ALL_METHODS = METHODS + (FUSED_METHOD,) + SAMPLED_METHODS
HOSTLOOP_METHODS = ("soman", "multijump")
# the methods whose torch-op hook rounds record the spanning forest
# (labelprop hooks nothing; the fused kernel records nothing;
# sampled_fused records its sample phase only, so it does not claim it)
FOREST_METHODS = ("soman", "multijump", "atomic_hook", "adaptive",
                  "sampled")


class CCResult(NamedTuple):
    labels: torch.Tensor      # int32 [V]; labels[v] = min id of v's component
    work: WorkCounters


class ForestResult(NamedTuple):
    """Labels plus the spanning forest recorded during hook rounds.

    ``parents`` is int32 [V, 2]: row r holds the graph edge whose hook
    retired root r; rows left (-1, -1) are the component roots, one per
    component, each its component's minimum. The recorded rows are |V| -
    C edges forming a spanning forest whose partition equals
    ``labels``."""

    labels: torch.Tensor
    parents: torch.Tensor
    work: WorkCounters


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------

def _cc_hook_rounds(edges: torch.Tensor, num_nodes: int, method: str,
                    num_segments: int, lift_steps: int = 2, true_edges=None,
                    ops: rounds.RoundOps | None = None) -> CCResult:
    """The hook-round variants (``soman`` and ``multijump`` unlifted,
    ``atomic_hook``, ``adaptive``) on ``ops``: each variant's torch ops
    by default; ``solve_forest`` passes recording ops."""
    if method in HOSTLOOP_METHODS:
        return _hook_jump_loop(edges, num_nodes, true_edges,
                               count_syncs=method == "soman", ops=ops)
    if method == "atomic_hook":
        return _cc_atomic_hook(edges, num_nodes, lift_steps, true_edges,
                               ops=ops)
    if method == "adaptive":
        return _cc_adaptive(edges, num_nodes, num_segments, lift_steps,
                            true_edges, ops=ops)
    raise ValueError(f"unknown method {method!r}; choose from "
                     f"{ALL_METHODS}")


def _hook_jump_loop(edges, num_nodes, true_edges, count_syncs,
                    ops: rounds.RoundOps | None = None) -> CCResult:
    """Unlifted hook rounds until a hook changes nothing, each followed
    by a full compress. Soman (``count_syncs``) bills one sync for the
    hook and one per jump sweep; multijump bills two syncs per round
    (one hook kernel + one fused Multi-Jump kernel). ``ops`` hooks
    (unlifted torch ops by default; recording ops record the forest)."""
    hook = (ops or rounds.torch_round_ops(0)).hook
    e = edges.shape[0] if true_edges is None else true_edges
    pi = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    work = WorkCounters.zeros(edges.device)
    changed, n = True, 0
    while changed and n < _MAX_ROUNDS:
        new_pi = hook(pi, edges)
        changed = bool((new_pi != pi).any())
        work = work.add(hook_ops=e, hook_rounds=1,
                        sync_rounds=1 if count_syncs else 2)
        pi, work = compress(new_pi, work, count_syncs=count_syncs)
        n += 1
    return CCResult(pi, work)


def _cc_atomic_hook(edges: torch.Tensor, num_nodes: int,
                    lift_steps: int = 2, true_edges=None,
                    ops: rounds.RoundOps | None = None) -> CCResult:
    """The adaptive cleanup loop run from scratch over the whole
    (single-segment) edge list; one sync (one fused device loop).
    ``ops``: torch ops with ``lift_steps`` by default."""
    pi0 = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    pi, work = rounds.cleanup_rounds(
        pi0, edges, ops or rounds.torch_round_ops(lift_steps),
        WorkCounters.zeros(edges.device), true_edges=true_edges)
    return CCResult(pi, work.add(sync_rounds=1))


def _cc_adaptive(edges: torch.Tensor, num_nodes: int, num_segments: int,
                 lift_steps: int = 2, true_edges=None,
                 ops: rounds.RoundOps | None = None) -> CCResult:
    """Fig. 4: for each of the s segments, Atomic-Hook the segment then
    fully compress, then a trailing consistency loop; one sync. ``ops``
    picks the backend (torch ops by default, the fused kernel for
    ``pallas_fused``)."""
    plan = plan_segmentation(edges.shape[0], num_nodes, num_segments)
    pi, work = rounds.adaptive_rounds(
        edges, num_nodes, plan, ops=ops, lift_steps=lift_steps,
        true_edges=edges.shape[0] if true_edges is None else true_edges)
    return CCResult(pi, work.add(sync_rounds=1))


# ---------------------------------------------------------------------------
# Engine entries
# ---------------------------------------------------------------------------

def solve_static(
    graph,
    num_nodes: int | None = None,
    method: str = "adaptive",
    *,
    num_segments: int | None = None,
    lift_steps: int = 2,
    device=None,
) -> CCResult:
    """Compute connected components.

    Args:
      graph: a ``repro_torch.graphs.device.DeviceGraph``, a host
        ``Graph``, or a raw [E, 2] int edge array (needs ``num_nodes``).
      num_nodes: |V| (only for raw edge arrays).
      method: ``soman | multijump | atomic_hook | adaptive | labelprop
        | pallas_fused | sampled | sampled_fused``, or ``auto``: the
        method policy (``repro_torch.connectivity.policy``) picks from
        the graph's size, density and degree skew, or from a measured
        autotune cache entry.
      num_segments: override the adaptive 2|E|/|V| heuristic.
      lift_steps: bounded root-chase depth of the Atomic-Hook analogue.
      device: where host input goes (CUDA when None).

    Returns:
      ``CCResult(labels, work)`` with canonical min-id labels, work
      billed on TRUE (unpadded) edges.
    """
    g = as_device_graph(graph, num_nodes, num_segments=num_segments,
                        device=device)
    if g.num_nodes <= 0:
        return CCResult(torch.zeros((0,), dtype=torch.int32, device=g.device),
                        WorkCounters.zeros(g.device))
    if g.is_empty:
        return CCResult(torch.arange(g.num_nodes, dtype=torch.int32,
                                     device=g.device),
                        WorkCounters.zeros(g.device))
    if method == "auto":
        from repro_torch.connectivity.policy import select_method
        method = select_method(g.num_nodes, g.num_edges,
                               degree_skew=g.degree_skew)
    if method in SAMPLED_METHODS:
        from repro_torch.core.sampled import solve_sampled
        res = solve_sampled(g, num_segments=num_segments,
                            lift_steps=lift_steps,
                            fused=(method == "sampled_fused"))
        return CCResult(res.labels, res.work)
    # exact-sized graphs bill the stored row count; padded graphs their
    # true count
    t = g.true_edges
    true = None if t == int(g.edges.shape[0]) else t
    s = g.plan.num_segments
    if method == FUSED_METHOD:
        return _cc_adaptive(g.edges, g.num_nodes, s, lift_steps, true,
                            ops=rounds.fused_round_ops(lift_steps))
    if method == "labelprop":
        from repro_torch.core.labelprop import _cc_labelprop
        return _cc_labelprop(g.edges, g.num_nodes, true)
    return _cc_hook_rounds(g.edges, g.num_nodes, method, s, lift_steps, true)


# ---------------------------------------------------------------------------
# Spanning-forest solves (forest recorded during hook rounds)
# ---------------------------------------------------------------------------

def _cc_forest(edges: torch.Tensor, num_nodes: int, method: str,
               num_segments: int, lift_steps: int = 2,
               true_edges=None) -> ForestResult:
    """``_cc_hook_rounds`` with recording ops: the same π updates and
    billing, with the parent-edge table recorded as they hook."""
    ops = rounds.forest_round_ops(
        rounds.empty_forest(num_nodes, edges.device),
        lift_steps=0 if method in HOSTLOOP_METHODS else lift_steps)
    res = _cc_hook_rounds(edges, num_nodes, method, num_segments,
                          lift_steps, true_edges, ops=ops)
    return ForestResult(res.labels, ops.tables()[0], res.work)


def solve_forest(graph, num_nodes: int | None = None,
                 method: str = "adaptive", *,
                 num_segments: int | None = None, lift_steps: int = 2,
                 device=None) -> ForestResult:
    """Connected components with the spanning forest the hook rounds
    record (the engine entry behind ``Solver.spanning_forest()``).

    ``method`` is one of ``FOREST_METHODS``; ``sampled`` records during
    both its sample phase and its residue scan. Labels and WorkCounters
    are those of ``solve_static`` with the same method."""
    if method not in FOREST_METHODS:
        raise ValueError(f"method {method!r} does not record a spanning "
                         f"forest; choose from {FOREST_METHODS}")
    g = as_device_graph(graph, num_nodes, num_segments=num_segments,
                        device=device)
    if g.num_nodes <= 0:
        return ForestResult(
            torch.zeros((0,), dtype=torch.int32, device=g.device),
            rounds.empty_forest(0, g.device), WorkCounters.zeros(g.device))
    if g.is_empty:
        return ForestResult(
            torch.arange(g.num_nodes, dtype=torch.int32, device=g.device),
            rounds.empty_forest(g.num_nodes, g.device),
            WorkCounters.zeros(g.device))
    if method == "sampled":
        from repro_torch.core.sampled import solve_sampled
        res = solve_sampled(g, num_segments=num_segments,
                            lift_steps=lift_steps, fused=False)
        return ForestResult(res.labels, res.parents, res.work)
    t = g.true_edges
    true = None if t == int(g.edges.shape[0]) else t
    return _cc_forest(g.edges, g.num_nodes, method, g.plan.num_segments,
                      lift_steps, true)


def solve_pallas(graph, num_nodes: int | None = None, *,
                 num_segments: int | None = None,
                 lift_steps: int = 2, device=None) -> torch.Tensor:
    """Adaptive CC on the per-round kernel backend ``pallas`` (hook +
    multi_jump kernels): one hook launch per segment and cleanup round,
    one compress launch after each. Returns canonical min-id labels.

    The backend promises labels only, as the reference's does (its
    counters are zeros by contract). So its hook is the TPU kernel at
    one tile per segment: every edge of a segment hooks from one π
    snapshot, on every SM. π after each segment and cleanup round is
    then the torch-ops ``adaptive``'s, and the hook launches equal its
    ``hook_rounds``."""
    g = as_device_graph(graph, num_nodes, num_segments=num_segments,
                        device=device)
    if g.num_nodes <= 0:
        return torch.zeros((0,), dtype=torch.int32, device=g.device)
    if g.edges.shape[0] == 0:
        return torch.arange(g.num_nodes, dtype=torch.int32, device=g.device)
    plan = plan_segmentation(g.edges.shape[0], g.num_nodes,
                             g.plan.num_segments)
    ops = rounds.pallas_round_ops(
        lift_steps=lift_steps, node_tile=min(512, max(8, g.num_nodes)))
    pi, _ = rounds.adaptive_rounds(g.edges, g.num_nodes, plan, ops=ops,
                                   true_edges=g.edges.shape[0])
    return pi


def solve_hostloop(edges, num_nodes: int, method: str = "soman", *,
                   device=None) -> tuple[np.ndarray, dict]:
    """The Soman baseline (or +multijump) with the GPU baseline's
    host-side control flow: one device-to-host read per convergence
    check. Returns (labels as numpy, stats) with ``hook_rounds``,
    ``jump_sweeps`` and ``sync_rounds``."""
    if method not in HOSTLOOP_METHODS:
        raise ValueError(f"unknown method {method!r}; choose from "
                         f"{HOSTLOOP_METHODS}")
    if isinstance(edges, torch.Tensor):
        edges = edges.to(torch.int32).reshape(-1, 2)
        if device is not None:
            edges = edges.to(resolve_device(device))
    else:
        edges = torch.from_numpy(
            np.asarray(edges, np.int32).reshape(-1, 2)).to(
                resolve_device(device))
    pi = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    syncs = 0
    stats = {"hook_rounds": 0, "jump_sweeps": 0}
    while True:
        new = hook_edges(pi, edges, lift_steps=0)
        hook_changed = bool((new != pi).any())     # device->host round trip
        pi = new
        stats["hook_rounds"] += 1
        syncs += 1
        if method == "soman":
            while True:
                new = jump_once(pi)
                jchanged = bool((new != pi).any())  # device->host round trip
                pi = new
                stats["jump_sweeps"] += 1
                syncs += 1
                if not jchanged:
                    break
        else:  # multijump: one fused compress kernel, one sync
            pi, w = compress(pi, WorkCounters.zeros(pi.device))
            stats["jump_sweeps"] += int(w.jump_sweeps)
            syncs += 1
        if not hook_changed:
            break
    stats["sync_rounds"] = syncs
    return pi.cpu().numpy(), stats
