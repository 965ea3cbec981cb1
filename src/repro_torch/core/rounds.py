"""Adaptive hook+compress round machinery (the non-forest half of
``repro.core.rounds``), on torch tensors.

Deterministic Hook (scatter-min with bounded root chase), Compress
(Jacobi pointer doubling to a fixpoint), the work counters, and the
segment-scan / cleanup-loop composition of the paper's Fig. 4.

The reference runs these loops as ``lax.while_loop``/``lax.scan``
inside one jitted program. Here they are Python loops on the host, and
a loop condition is read back from the device (``.item()``-style) once
per iteration. ``WorkCounters`` still bill exactly what the reference
bills — ``sync_rounds`` counts the reference's host-equivalent
synchronisation points, not the host reads this eager loop makes — so
the counters of both packages compare equal field by field.

Work accounting bills *true* edge counts: padded ``(0, 0)`` no-op edges
are never counted. Counters are 0-d int32 tensors on the graph's device
and wrap on overflow exactly where the reference's int32 counters wrap.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.segmentation import SegmentationPlan

MAX_ROUNDS = 64          # outer hook-round fuel


def compress_fuel(num_nodes: int) -> int:
    """Pointer doubling squares path lengths per sweep, so
    ceil(log2(V)) + 2 sweeps provably flatten any forest on V nodes."""
    return max(4, math.ceil(math.log2(max(num_nodes, 2))) + 2)


def wrap_int32(x: int) -> int:
    """A Python int reduced to int32 two's complement (what the
    reference's int32 counters hold after the same additions)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


class WorkCounters(NamedTuple):
    """Hardware-independent work counters, as in the reference:

    * ``hook_ops``    — edge-hook evaluations performed (true edges only),
    * ``jump_ops``    — vertex-jump (gather) evaluations performed,
    * ``jump_sweeps`` — full |V|-wide pointer-jump sweeps,
    * ``hook_rounds`` — edge-set hook rounds,
    * ``sync_rounds`` — host-equivalent synchronization points of the
      reference's execution (not of this eager port's).
    """

    hook_ops: torch.Tensor
    jump_ops: torch.Tensor
    jump_sweeps: torch.Tensor
    hook_rounds: torch.Tensor
    sync_rounds: torch.Tensor

    @staticmethod
    def zeros(device) -> "WorkCounters":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return WorkCounters(z, z, z, z, z)

    def add(self, **kw) -> "WorkCounters":
        """Add int32 amounts: tensors are cast, Python ints wrapped."""
        d = self._asdict()
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                d[k] = d[k] + v.to(torch.int32)
            else:
                d[k] = d[k] + wrap_int32(v)
        return WorkCounters(**d)

    def as_ints(self) -> dict:
        return {k: int(v) for k, v in self._asdict().items()}


# ---------------------------------------------------------------------------
# Primitive operations
# ---------------------------------------------------------------------------

def hook_edges(pi: torch.Tensor, edges: torch.Tensor, lift_steps: int = 0
               ) -> torch.Tensor:
    """One deterministic hook round over ``edges`` ([..., 2]).

    For every edge (u, v): H = max(pi(u), pi(v)), L = min(...), then
    ``pi[H] <- min(pi[H], L)`` via scatter-min, every read from one π
    snapshot. ``lift_steps`` performs the bounded root chase
    (pu <- pi[pu]) before hooking. Returns a new tensor.
    """
    u, v = edges[..., 0].reshape(-1), edges[..., 1].reshape(-1)
    pu, pv = pi[u], pi[v]
    for _ in range(lift_steps):
        pu, pv = pi[pu], pi[pv]
    hi = torch.maximum(pu, pv)
    lo = torch.minimum(pu, pv)
    return pi.scatter_reduce(0, hi.long(), lo, reduce="amin",
                             include_self=True)


def jump_once(pi: torch.Tensor) -> torch.Tensor:
    """Single-level Jump (Fig. 2): pi <- pi[pi] for every vertex."""
    return pi[pi]


def jacobi_sweeps(pi: torch.Tensor, fuel: int) -> tuple[torch.Tensor, int]:
    """Jacobi ``pi <- pi[pi]`` sweeps while anything changes and fewer
    than ``fuel`` sweeps ran. Returns (pi, sweeps executed), counting
    the final sweep that changed nothing."""
    sweeps = 0
    changed = True
    while changed and sweeps < fuel:
        nxt = pi[pi]
        changed = bool((nxt != pi).any())
        pi = nxt
        sweeps += 1
    return pi, sweeps


def compress(pi: torch.Tensor, work: WorkCounters,
             count_syncs: bool = False,
             bill_nodes: int | None = None,
             ) -> tuple[torch.Tensor, WorkCounters]:
    """Full Compress via pointer doubling under ``compress_fuel(V)``.
    Each sweep bills ``bill_nodes`` (default |V|) jump_ops and one
    jump_sweep; with ``count_syncs`` also one sync_round (the Soman
    baseline checks convergence from the host after every sweep)."""
    v = pi.shape[0] if bill_nodes is None else bill_nodes
    pi, sweeps = jacobi_sweeps(pi, compress_fuel(pi.shape[0]))
    work = work.add(jump_ops=v * sweeps, jump_sweeps=sweeps,
                    sync_rounds=sweeps if count_syncs else 0)
    return pi, work


def edges_consistent(pi: torch.Tensor, edges: torch.Tensor) -> bool:
    """True iff every edge has both endpoints under the same label."""
    return bool((pi[edges[..., 0]] == pi[edges[..., 1]]).all())


# ---------------------------------------------------------------------------
# Pluggable round operations
# ---------------------------------------------------------------------------

class RoundOps(NamedTuple):
    """The pluggable kernels of a hook+compress round.

    * ``hook(pi, edges) -> pi``        — one hook pass over an edge set,
    * ``compress(pi, work) -> (pi, work)`` — full compress, threading work,
    * ``bill_lift``                    — hook evaluations billed per true
                                         edge (1 + lift_steps),
    * ``scan``                         — optional FUSED segment scan:
      ``scan(pi, segments, true_counts, work) -> (pi, work)`` runs the
      whole Fig. 4 inner pipeline in ONE kernel launch, billing
      internally; ``cleanup_rounds`` then issues one launch per round.
    """

    hook: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    compress: Callable[[torch.Tensor, WorkCounters],
                       tuple[torch.Tensor, WorkCounters]]
    bill_lift: int
    scan: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, WorkCounters],
                   tuple[torch.Tensor, WorkCounters]] | None = None


def torch_round_ops(lift_steps: int = 2) -> RoundOps:
    """Plain torch ops (the default backend; the reference's
    ``jnp_round_ops``)."""
    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=compress,
        bill_lift=1 + lift_steps,
    )


def pallas_round_ops(lift_steps: int, edge_tile: int, node_tile: int
                     ) -> RoundOps:
    """Per-round kernel ops (backend ``pallas``): the ``hook`` kernel
    and the ``multi_jump`` compress kernel. The kernels do not thread
    work counters; compress passes them through, as in the reference."""
    from repro_torch.kernels.hook.ops import hook_edges_pallas
    from repro_torch.kernels.multi_jump.ops import full_compress
    return RoundOps(
        hook=lambda pi, e: hook_edges_pallas(
            pi, e, edge_tile=edge_tile, lift_steps=lift_steps),
        compress=lambda pi, w: (full_compress(pi, tile=node_tile), w),
        bill_lift=1 + lift_steps,
    )


def fused_round_ops(lift_steps: int = 2) -> RoundOps:
    """Fused-kernel ops (backend ``pallas_fused``, ``kernels.cc_fused``):
    the whole segment scan in ONE kernel launch. Billing is bit-equal
    to the torch-ops backend: hook_ops on TRUE per-segment counts,
    jump_sweeps from the kernel's per-segment sweep counts."""
    from repro_torch.kernels.cc_fused.ops import fused_segment_scan
    bill = 1 + lift_steps

    def scan(pi, segments, true_counts, work):
        v = pi.shape[0]
        pi, sweeps = fused_segment_scan(pi, segments, true_counts,
                                        lift_steps=lift_steps)
        total = sweeps.sum(dtype=torch.int32)
        return pi, work.add(
            hook_ops=true_counts.sum(dtype=torch.int32) * bill,
            hook_rounds=segments.shape[0],
            jump_ops=total * wrap_int32(v), jump_sweeps=total)

    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=compress,
        bill_lift=bill,
        scan=scan,
    )


# ---------------------------------------------------------------------------
# Segmentation helpers
# ---------------------------------------------------------------------------

def pad_and_segment(edges: torch.Tensor, plan: SegmentationPlan
                    ) -> torch.Tensor:
    """Pad ``edges`` with (0, 0) no-ops to ``plan.padded_edges`` and
    reshape to [num_segments, segment_size, 2]."""
    pad = plan.padded_edges - edges.shape[0]
    if pad > 0:
        edges = torch.cat([edges, edges.new_zeros((pad, 2))], dim=0)
    return edges.reshape(plan.num_segments, plan.segment_size, 2)


def segment_true_counts(true_edges: int, plan: SegmentationPlan,
                        device=None) -> torch.Tensor:
    """Per-segment count of *true* (unpadded) edges, [num_segments]
    int32: segment i holds edge slots [i*seg, (i+1)*seg), and the first
    ``true_edges`` slots are real."""
    starts = torch.arange(plan.num_segments, dtype=torch.int32,
                          device=device) * plan.segment_size
    return torch.clamp(wrap_int32(true_edges) - starts, 0, plan.segment_size)


# ---------------------------------------------------------------------------
# Round composition (Fig. 4)
# ---------------------------------------------------------------------------

def segment_scan(pi: torch.Tensor, segments: torch.Tensor, ops: RoundOps,
                 work: WorkCounters,
                 true_counts: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, WorkCounters]:
    """Fig. 4 inner structure: for each segment, hook then fully
    compress. ``true_counts`` ([num_segments] int32) bills hook_ops per
    segment on true edges only; None bills the full segment size. With
    fused ops (``ops.scan`` set) the whole scan is ONE kernel launch."""
    if true_counts is None:
        true_counts = torch.full((segments.shape[0],), segments.shape[1],
                                 dtype=torch.int32, device=segments.device)
    if ops.scan is not None:
        return ops.scan(pi, segments, true_counts, work)
    for seg, cnt in zip(segments, true_counts.tolist()):
        pi = ops.hook(pi, seg)
        work = work.add(hook_ops=cnt * ops.bill_lift, hook_rounds=1)
        pi, work = ops.compress(pi, work)
    return pi, work


def cleanup_rounds(pi: torch.Tensor, edges: torch.Tensor, ops: RoundOps,
                   work: WorkCounters,
                   true_edges: int | None = None,
                   max_rounds: int = MAX_ROUNDS,
                   ) -> tuple[torch.Tensor, WorkCounters]:
    """Re-hook ``edges`` until every edge is consistent (usually 0-1
    rounds), covering hook candidates dropped by deterministic
    min-selection. The initial consistency check short-circuits
    already-consistent edge sets to zero hook rounds."""
    if true_edges is None:
        true_edges = edges.shape[0]
    bill = true_edges * ops.bill_lift
    true1 = torch.tensor([wrap_int32(true_edges)], dtype=torch.int32,
                         device=edges.device)
    rounds = 0
    done = edges_consistent(pi, edges)
    while not done and rounds < max_rounds:
        if ops.scan is not None:
            # fused backend: hook + full compress of the (single-segment)
            # edge set in ONE launch per cleanup round
            pi, work = ops.scan(pi, edges[None], true1, work)
        else:
            pi = ops.hook(pi, edges)
            work = work.add(hook_ops=bill, hook_rounds=1)
            pi, work = ops.compress(pi, work)
        done = edges_consistent(pi, edges)
        rounds += 1
    return pi, work


def adaptive_rounds(edges: torch.Tensor, num_nodes: int,
                    plan: SegmentationPlan, *,
                    ops: RoundOps | None = None,
                    lift_steps: int = 2,
                    true_edges: int | None = None,
                    max_rounds: int = MAX_ROUNDS,
                    ) -> tuple[torch.Tensor, WorkCounters]:
    """The full adaptive pipeline (Fig. 4): segment scan, then cleanup.
    ``true_edges`` defaults to ``plan.num_edges``. Returns (labels,
    work) — callers add their own sync_rounds billing."""
    if ops is None:
        ops = torch_round_ops(lift_steps)
    if true_edges is None:
        true_edges = plan.num_edges
    segments = pad_and_segment(edges, plan)
    counts = segment_true_counts(true_edges, plan, device=edges.device)
    pi0 = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    pi, work = segment_scan(pi0, segments, ops,
                            WorkCounters.zeros(edges.device),
                            true_counts=counts)
    flat = segments.reshape(-1, 2)
    pi, work = cleanup_rounds(pi, flat, ops, work, true_edges=true_edges,
                              max_rounds=max_rounds)
    return pi, work
