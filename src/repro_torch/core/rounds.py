"""Adaptive hook+compress round machinery of ``repro.core.rounds``, on
torch tensors.

Deterministic Hook (scatter-min with bounded root chase), Compress
(Jacobi pointer doubling to a fixpoint), the work counters, the
segment-scan / cleanup-loop composition of the paper's Fig. 4, and the
same compositions with the spanning forest recorded as they hook. The
id-recording forest rounds of the dynamic engine are not here yet.

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


def pallas_round_ops(lift_steps: int, node_tile: int) -> RoundOps:
    """Per-round kernel ops (backend ``pallas``): the ``hook`` kernel at
    one tile per edge set (every edge hooks from one π snapshot, as
    ``hook_edges`` does) and the ``multi_jump`` compress kernel. The
    kernels do not thread work counters; compress passes them through,
    as in the reference."""
    from repro_torch.kernels.hook.ops import hook_edges_snapshot
    from repro_torch.kernels.multi_jump.ops import full_compress
    return RoundOps(
        hook=lambda pi, e: hook_edges_snapshot(pi, e, lift_steps=lift_steps),
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


# ---------------------------------------------------------------------------
# Forest-recording hook (spanning forest as a by-product of hook rounds)
# ---------------------------------------------------------------------------
# Every hook round runs over a fully compressed π, so a scatter-min write
# at ``hi`` strictly lowers a root's own label (π[hi] == hi before, lo <
# hi after) and hi never reappears as a label. Each row is recorded at
# most once over the run, each recorded edge merges two components that
# were distinct when it was recorded, and the recorded rows are a
# spanning forest: V - C edges, one unrecorded root (the component
# minimum) per component. These compositions are separate from the plain
# ones so that the plain paths stay as they are.

_INT32_MAX = 2**31 - 1


def empty_forest(num_nodes: int, device=None) -> torch.Tensor:
    """int32 [V, 2] parent-edge table, all (-1, -1): row r will hold the
    graph edge whose hook retired root r; rows still (-1, -1) at the end
    are the component roots."""
    return torch.full((num_nodes, 2), -1, dtype=torch.int32, device=device)


def hook_edges_forest(pi: torch.Tensor, parents: torch.Tensor,
                      edges: torch.Tensor, lift_steps: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``hook_edges`` plus spanning-forest recording (same π update).

    An edge wins row ``hi`` iff its scatter-min write landed
    (``new_pi[hi] == lo``) and strictly lowered the root's label
    (``new_pi[hi] < pi[hi]``: no self loops, duplicates or merged
    endpoints). Ties between edges of the same (hi, lo) go to the lowest
    edge index, by a second scatter-min over edge indices, so exactly one
    edge is recorded per retired root.

    A write that cannot lower its target (``lo >= pi[hi]``, and every
    loser of the edge-index scatter) is a no-op. Such writes are sent as
    the int32 maximum to a row picked by edge index instead, which
    leaves every result as it was and spares the single-address storms
    of the reference's layout: the edges of a merged component all
    hitting its root, and the losers all hitting the reference's drop
    row (``mode="drop"`` at index V). The parent rows of the losers go
    to a sentinel row V of a [V + 1] buffer that is sliced off, so no
    index past a buffer reaches a scatter.
    """
    n = pi.shape[0]
    edges = edges.reshape(-1, 2)
    u, v = edges[:, 0], edges[:, 1]
    pu, pv = pi[u], pi[v]
    for _ in range(lift_steps):
        pu, pv = pi[pu], pi[pv]
    hi = torch.maximum(pu, pv).long()
    lo = torch.minimum(pu, pv)
    eidx = torch.arange(edges.shape[0], dtype=torch.int32, device=pi.device)
    spread = eidx.long() % max(n, 1)
    before = pi[hi]
    live = lo < before
    new_pi = pi.scatter_reduce(0, torch.where(live, hi, spread),
                               torch.where(live, lo, _INT32_MAX),
                               reduce="amin", include_self=True)
    at_hi = new_pi[hi]
    won = (at_hi == lo) & (at_hi < before)
    winner = torch.full((n,), _INT32_MAX, dtype=torch.int32,
                        device=pi.device)
    winner = winner.scatter_reduce(0, torch.where(won, hi, spread),
                                   torch.where(won, eidx, _INT32_MAX),
                                   reduce="amin")
    rec = won & (winner[hi] == eidx)
    buf = torch.cat([parents, parents.new_full((1, 2), -1)])
    buf = buf.index_put((torch.where(rec, hi, n),), edges)
    return new_pi, buf[:n]


def forest_segment_scan(pi: torch.Tensor, parents: torch.Tensor,
                        segments: torch.Tensor, work: WorkCounters,
                        true_counts: torch.Tensor, lift_steps: int = 2,
                        ) -> tuple[torch.Tensor, torch.Tensor, WorkCounters]:
    """``segment_scan`` with the parent-edge table threaded through it
    (torch ops only; billing as ``torch_round_ops``).

    A segment's true edges are its first ``true_counts`` rows and the
    rest are (0, 0) padding. Over a compressed π (every hook here
    follows a compress, or starts from one) a (0, 0) row changes
    neither π nor the forest, so only the true prefix is hooked: the
    result is the reference's, without every padding row's write
    landing on π[0]'s root."""
    bill = 1 + lift_steps
    for seg, cnt in zip(segments, true_counts.tolist()):
        pi, parents = hook_edges_forest(pi, parents, seg[:cnt],
                                        lift_steps=lift_steps)
        work = work.add(hook_ops=cnt * bill, hook_rounds=1)
        pi, work = compress(pi, work)
    return pi, parents, work


def forest_cleanup_rounds(pi: torch.Tensor, parents: torch.Tensor,
                          edges: torch.Tensor, work: WorkCounters,
                          true_edges: int | None = None,
                          lift_steps: int = 2,
                          max_rounds: int = MAX_ROUNDS,
                          ) -> tuple[torch.Tensor, torch.Tensor, WorkCounters]:
    """``cleanup_rounds`` with forest recording (the same short-circuit
    on an already consistent edge set, the same true-edge billing).
    Rows past ``true_edges`` are (0, 0) padding, consistent and no-ops
    over a compressed π, so only the true prefix is checked and hooked
    (see ``forest_segment_scan``)."""
    if true_edges is None:
        true_edges = edges.shape[0]
    edges = edges[:true_edges]
    bill = true_edges * (1 + lift_steps)
    rounds = 0
    done = edges_consistent(pi, edges)
    while not done and rounds < max_rounds:
        pi, parents = hook_edges_forest(pi, parents, edges,
                                        lift_steps=lift_steps)
        work = work.add(hook_ops=bill, hook_rounds=1)
        pi, work = compress(pi, work)
        done = edges_consistent(pi, edges)
        rounds += 1
    return pi, parents, work


def forest_adaptive_rounds(edges: torch.Tensor, num_nodes: int,
                           plan: SegmentationPlan, *,
                           lift_steps: int = 2,
                           true_edges: int | None = None,
                           max_rounds: int = MAX_ROUNDS,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      WorkCounters]:
    """The Fig. 4 pipeline (segment scan, then cleanup) with the
    spanning forest recorded along the way. Labels and counters equal
    ``adaptive_rounds``'s."""
    if true_edges is None:
        true_edges = plan.num_edges
    dev = edges.device
    segments = pad_and_segment(edges, plan)
    counts = segment_true_counts(true_edges, plan, device=dev)
    pi0 = torch.arange(num_nodes, dtype=torch.int32, device=dev)
    pi, parents, work = forest_segment_scan(
        pi0, empty_forest(num_nodes, dev), segments,
        WorkCounters.zeros(dev), counts, lift_steps=lift_steps)
    pi, parents, work = forest_cleanup_rounds(
        pi, parents, segments.reshape(-1, 2), work, true_edges=true_edges,
        lift_steps=lift_steps, max_rounds=max_rounds)
    return pi, parents, work
