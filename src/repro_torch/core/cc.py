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

The backend names are the reference's, so that code keyed on them reads
the same in both packages. Every variant returns canonical labels
(``labels[v] == min vertex id of v's component``) and ``WorkCounters``
equal to the reference's field by field; work bills TRUE (unpadded)
edges. The reference's jitted while-loops are host loops here, and
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
HOSTLOOP_METHODS = ("soman", "multijump")
# not in this package yet: "auto" needs the method policy, the sampled
# engines come later (ROADMAP.md queue A)
_NOT_PORTED = {"auto": "A4", "sampled": "A7", "sampled_fused": "A7"}


class CCResult(NamedTuple):
    labels: torch.Tensor      # int32 [V]; labels[v] = min id of v's component
    work: WorkCounters


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------

def _cc_soman(edges: torch.Tensor, num_nodes: int,
              true_edges=None) -> CCResult:
    return _hook_jump_loop(edges, num_nodes, true_edges, count_syncs=True)


def _cc_multijump(edges: torch.Tensor, num_nodes: int,
                  true_edges=None) -> CCResult:
    return _hook_jump_loop(edges, num_nodes, true_edges, count_syncs=False)


def _hook_jump_loop(edges, num_nodes, true_edges, count_syncs) -> CCResult:
    """Unlifted hook rounds until a hook changes nothing, each followed
    by a full compress. Soman (``count_syncs``) bills one sync for the
    hook and one per jump sweep; multijump bills two syncs per round
    (one hook kernel + one fused Multi-Jump kernel)."""
    e = edges.shape[0] if true_edges is None else true_edges
    pi = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    work = WorkCounters.zeros(edges.device)
    changed, n = True, 0
    while changed and n < _MAX_ROUNDS:
        new_pi = hook_edges(pi, edges, lift_steps=0)
        changed = bool((new_pi != pi).any())
        work = work.add(hook_ops=e, hook_rounds=1,
                        sync_rounds=1 if count_syncs else 2)
        pi, work = compress(new_pi, work, count_syncs=count_syncs)
        n += 1
    return CCResult(pi, work)


def _cc_atomic_hook(edges: torch.Tensor, num_nodes: int,
                    lift_steps: int = 2, true_edges=None) -> CCResult:
    """The adaptive cleanup loop run from scratch over the whole
    (single-segment) edge list; one sync (one fused device loop)."""
    if true_edges is None:
        true_edges = edges.shape[0]
    pi0 = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    pi, work = rounds.cleanup_rounds(
        pi0, edges, rounds.torch_round_ops(lift_steps),
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
        | pallas_fused``. ``auto`` (method policy) and the sampled
        engines are not in this package yet and raise
        ``NotImplementedError``.
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
    if g.edges.shape[0] == 0 or g.true_edges == 0:
        return CCResult(torch.arange(g.num_nodes, dtype=torch.int32,
                                     device=g.device),
                        WorkCounters.zeros(g.device))
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP.md queue A, "
            f"item {_NOT_PORTED[method]})")
    # exact-sized graphs bill the stored row count; padded graphs their
    # true count
    t = g.true_edges
    true = None if t == int(g.edges.shape[0]) else t
    s = g.plan.num_segments
    if method == FUSED_METHOD:
        return _cc_adaptive(g.edges, g.num_nodes, s, lift_steps, true,
                            ops=rounds.fused_round_ops(lift_steps))
    if method == "soman":
        return _cc_soman(g.edges, g.num_nodes, true)
    if method == "multijump":
        return _cc_multijump(g.edges, g.num_nodes, true)
    if method == "atomic_hook":
        return _cc_atomic_hook(g.edges, g.num_nodes, lift_steps, true)
    if method == "adaptive":
        return _cc_adaptive(g.edges, g.num_nodes, s, lift_steps, true)
    if method == "labelprop":
        from repro_torch.core.labelprop import _cc_labelprop
        return _cc_labelprop(g.edges, g.num_nodes, true)
    raise ValueError(f"unknown method {method!r}; choose from "
                     f"{METHODS + (FUSED_METHOD,)}")


def solve_pallas(graph, num_nodes: int | None = None, *,
                 num_segments: int | None = None,
                 lift_steps: int = 2, device=None) -> torch.Tensor:
    """Adaptive CC on the per-round kernel backend ``pallas`` (hook +
    multi_jump kernels): one hook launch per segment and cleanup round,
    one compress launch after each. Returns canonical min-id labels."""
    g = as_device_graph(graph, num_nodes, num_segments=num_segments,
                        device=device)
    if g.num_nodes <= 0:
        return torch.zeros((0,), dtype=torch.int32, device=g.device)
    if g.edges.shape[0] == 0:
        return torch.arange(g.num_nodes, dtype=torch.int32, device=g.device)
    plan = plan_segmentation(g.edges.shape[0], g.num_nodes,
                             g.plan.num_segments)
    ops = rounds.pallas_round_ops(
        lift_steps=lift_steps,
        edge_tile=min(1024, plan.segment_size),
        node_tile=min(512, max(8, g.num_nodes)))
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
