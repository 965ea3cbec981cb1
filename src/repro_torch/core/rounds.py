"""Adaptive hook+compress round machinery of ``repro.core.rounds``, on
torch tensors.

Deterministic Hook (scatter-min with bounded root chase), Compress
(Jacobi pointer doubling to a fixpoint), the work counters, the
segment-scan / cleanup-loop composition of the paper's Fig. 4, the
same compositions with the spanning forest recorded as they hook, and
the dynamic engine's scoped recomputes: ``scoped_rounds`` (the plain
scoped delete) and ``forest_scoped_rounds`` with the id-recording
rounds beneath it (the tree-aware delete).

The reference runs these loops as ``lax.while_loop``/``lax.scan``
inside one jitted program. Here they are Python loops on the host, and
a loop condition is read back from the device (``.item()``-style) once
per iteration. ``WorkCounters`` still bill exactly what the reference
bills — ``sync_rounds`` counts the reference's host-equivalent
synchronisation points, not the host reads this eager loop makes — so
the counters of both packages compare equal field by field (below
2^31, where the reference's int32 counters wrap). The reads
themselves are counted by ``obs.read`` under ``read.<site>``: ``sweep``
(a compress sweep's changed flag), ``consistent`` (the cleanup loop's
check), ``scan_counts``, ``scoped_rows``, ``scoped_counts``,
``forest_counts`` and ``pack`` (the row counts and ``nonzero`` packs
the host sizes loops and buffers by), and ``scan_sweeps`` (the sweeps
of an id-recording scan run in one launch where π fits the L2: there
``read.sweep`` counts none of them). The Fig. 4 pipeline runs under
the spans ``cc.scan`` and ``cc.cleanup``, the tree-aware delete under
``dyn.forest.skeleton`` and ``dyn.forest.replace``; on torch ops each
ends on a read, so its host time is the phase's wall time (a fused
scan is one launch that reads nothing back).

Work accounting bills *true* edge counts: padded ``(0, 0)`` no-op edges
are never counted. Counters are 0-d int64 tensors on the graph's device:
they equal the reference's int32 counters wherever those do not wrap
(below 2^31), and stay exact past it, where a graph of 174M vertices
bills |V| a sweep and 3 hook_ops an edge a pass. ``cc.scan`` and
``cc.cleanup`` are tagged with the Jacobi ``sweeps`` they ran, and
``cc.cleanup`` with its hook ``rounds``, from the host's own counts of
the reads above.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.segmentation import SegmentationPlan
from repro_torch.obs import trace as obs

MAX_ROUNDS = 64          # outer hook-round fuel


def compress_fuel(num_nodes: int) -> int:
    """Pointer doubling squares path lengths per sweep, so
    ceil(log2(V)) + 2 sweeps provably flatten any forest on V nodes."""
    return max(4, math.ceil(math.log2(max(num_nodes, 2))) + 2)


def wrap_int32(x: int) -> int:
    """A Python int reduced to int32 two's complement, for the int32
    tensors of row counts (``check_shard_extent`` bounds them)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


class WorkCounters(NamedTuple):
    """Hardware-independent work counters, the reference's fields in
    int64 (equal to its int32 counters below 2^31):

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
        z = torch.zeros((), dtype=torch.int64, device=device)
        return WorkCounters(z, z, z, z, z)

    def add(self, **kw) -> "WorkCounters":
        """Add exact amounts: tensors are cast to int64, Python ints
        added as they are."""
        d = self._asdict()
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                v = v.to(torch.int64)
            d[k] = d[k] + v
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
        changed = obs.read("sweep", lambda: bool((nxt != pi).any()))
        pi = nxt
        sweeps += 1
    return pi, sweeps


def _sweep_bill(num_nodes: int, bill_nodes, sweeps: int):
    """jump_ops for ``sweeps`` sweeps billed at ``bill_nodes`` (default
    |V|) each: an int64 tensor when ``bill_nodes`` is a tensor, else an
    int."""
    v = num_nodes if bill_nodes is None else bill_nodes
    if isinstance(v, torch.Tensor):
        v = v.to(torch.int64)
    return v * sweeps


def compress(pi: torch.Tensor, work: WorkCounters,
             count_syncs: bool = False,
             bill_nodes: int | torch.Tensor | None = None,
             ) -> tuple[torch.Tensor, WorkCounters]:
    """Full Compress via pointer doubling under ``compress_fuel(V)``.
    Each sweep bills ``bill_nodes`` (default |V|; an int or an integer
    0-d tensor) jump_ops and one jump_sweep; with ``count_syncs`` also
    one sync_round (the Soman baseline checks convergence from the host
    after every sweep)."""
    pi, sweeps = jacobi_sweeps(pi, compress_fuel(pi.shape[0]))
    work = work.add(jump_ops=_sweep_bill(pi.shape[0], bill_nodes, sweeps),
                    jump_sweeps=sweeps,
                    sync_rounds=sweeps if count_syncs else 0)
    return pi, work


def edges_consistent(pi: torch.Tensor, edges: torch.Tensor) -> bool:
    """True iff every edge has both endpoints under the same label."""
    return obs.read("consistent", lambda: bool(
        (pi[edges[..., 0]] == pi[edges[..., 1]]).all()))


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


def torch_round_ops(lift_steps: int = 2,
                    bill_nodes: int | torch.Tensor | None = None
                    ) -> RoundOps:
    """Plain torch ops (the default backend; the reference's
    ``jnp_round_ops``). ``bill_nodes`` (an int or an integer 0-d tensor)
    replaces |V| as the jump_ops billed per compress sweep: the scoped
    recompute bills its affected-vertex count."""
    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=lambda pi, w: compress(pi, w, bill_nodes=bill_nodes),
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


def fused_round_ops(lift_steps: int = 2,
                    bill_nodes: int | torch.Tensor | None = None
                    ) -> RoundOps:
    """Fused-kernel ops (backend ``pallas_fused``, ``kernels.cc_fused``):
    the whole segment scan in ONE kernel launch. Billing is bit-equal
    to the torch-ops backend: hook_ops on TRUE per-segment counts,
    jump_sweeps from the kernel's per-segment sweep counts, jump_ops
    ``bill_nodes`` (default |V|) per sweep."""
    from repro_torch.kernels.cc_fused.ops import fused_segment_scan
    bill = 1 + lift_steps

    def scan(pi, segments, true_counts, work):
        v = pi.shape[0] if bill_nodes is None else bill_nodes
        pi, sweeps = fused_segment_scan(pi, segments, true_counts,
                                        lift_steps=lift_steps)
        total = sweeps.sum(dtype=torch.int64)
        return pi, work.add(
            hook_ops=true_counts.sum(dtype=torch.int64) * bill,
            hook_rounds=segments.shape[0],
            jump_ops=total * (v.to(torch.int64)
                              if isinstance(v, torch.Tensor) else v),
            jump_sweeps=total)

    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=lambda pi, w: compress(pi, w, bill_nodes=bill_nodes),
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
    counts = obs.read("scan_counts", lambda: true_counts.tolist())
    for seg, cnt in zip(segments, counts):
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
    with obs.span("cc.scan", segments=plan.num_segments) as sp:
        sweeps0 = _reads("sweep")
        pi, work = segment_scan(pi0, segments, ops,
                                WorkCounters.zeros(edges.device),
                                true_counts=counts)
        if ops.scan is None:
            sp.tag(sweeps=_reads("sweep") - sweeps0)
    flat = segments.reshape(-1, 2)
    with obs.span("cc.cleanup") as sp:
        sweeps0, checks0 = _reads("sweep"), _reads("consistent")
        pi, work = cleanup_rounds(pi, flat, ops, work,
                                  true_edges=true_edges,
                                  max_rounds=max_rounds)
        # one check before the first round and one after each
        sp.tag(rounds=_reads("consistent") - checks0 - 1)
        if ops.scan is None:
            sp.tag(sweeps=_reads("sweep") - sweeps0)
    return pi, work


def _reads(site: str) -> int:
    """The host reads made so far at ``site`` (``obs.read`` counts them
    whether or not tracing is on). A Jacobi sweep reads its changed flag
    once and a cleanup round its consistency once, so their differences
    count a phase's sweeps and rounds without reading the device. The
    fused scan's sweeps are counted on the device: its phases carry no
    ``sweeps`` tag."""
    return obs.tracer().counters.get("read." + site, 0)


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
    new_pi, hi, rec = _forest_hook(pi, edges.reshape(-1, 2), lift_steps)
    return new_pi, _record_rows(parents, hi, rec, edges.reshape(-1, 2))


def _forest_hook(pi: torch.Tensor, edges: torch.Tensor, lift_steps: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hook of ``hook_edges_forest`` in the storm-free layout its
    docstring sets out: returns (new π, ``hi`` int64 [E], ``rec`` bool
    [E] marking the one winning row per retired root)."""
    n = pi.shape[0]
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
    return new_pi, hi, won & (winner[hi] == eidx)


def _record_rows(table: torch.Tensor, hi: torch.Tensor, rec: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``table[hi[i]] = values[i]`` for the rows under ``rec``; the other
    rows write to a sentinel row past the table, sliced off."""
    buf = _with_sentinel(table)
    _record_rows_(buf, hi, rec, values)
    return buf[:table.shape[0]]


def _with_sentinel(table: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with one more row: the sentinel row that
    ``_record_rows_`` sends the losing rows to."""
    return torch.cat([table, table.new_full((1,) + table.shape[1:], -1)])


def _record_rows_(buf: torch.Tensor, hi: torch.Tensor, rec: torch.Tensor,
                  values: torch.Tensor) -> None:
    """In place on a sentinel-extended table: ``buf[hi[i]] = values[i]``
    for the rows under ``rec``, the others to the last row."""
    buf.index_put_((torch.where(rec, hi, buf.shape[0] - 1),), values)


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
    counts = obs.read("scan_counts", lambda: true_counts.tolist())
    for seg, cnt in zip(segments, counts):
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


# ---------------------------------------------------------------------------
# Id-recording forest rounds (the maintained forest of the dynamic engine)
# ---------------------------------------------------------------------------
# The same win rule as above, but each recorded row also keeps WHICH edge
# won: an external id (the EdgeLog row) scattered beside the endpoints.
# ``parent_eidx[r]`` is the log row of the edge at ``parents[r]`` (-1 for
# roots), which lets a delete batch classify tree and non-tree hits with
# one O(V) gather. Every composition here hooks over a compressed π, so a
# (0, 0) row (id -1) is a no-op that can never win: rows known to be such
# padding are left out, which changes no result.

def empty_forest_idx(num_nodes: int, device=None) -> torch.Tensor:
    """int32 [V] log-row table matching ``empty_forest``: all -1."""
    return torch.full((num_nodes,), -1, dtype=torch.int32, device=device)


def hook_edges_forest_ids(pi: torch.Tensor, parents: torch.Tensor,
                          parent_eidx: torch.Tensor, edges: torch.Tensor,
                          edge_ids: torch.Tensor, lift_steps: int = 0,
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``hook_edges_forest`` plus external-id recording: the same π
    update and the same tie-break (the lowest batch slot wins), and the
    winning slot's ``edge_ids`` entry lands in ``parent_eidx`` under the
    same rule, in the same storm-free layout."""
    edges = edges.reshape(-1, 2)
    new_pi, hi, rec = _forest_hook(pi, edges, lift_steps)
    return (new_pi, _record_rows(parents, hi, rec, edges),
            _record_rows(parent_eidx, hi, rec, edge_ids.reshape(-1)))


def forest_cleanup_rounds_ids(pi: torch.Tensor, parents: torch.Tensor,
                              parent_eidx: torch.Tensor,
                              edges: torch.Tensor, edge_ids: torch.Tensor,
                              work: WorkCounters,
                              true_edges: int | torch.Tensor | None = None,
                              lift_steps: int = 2,
                              max_rounds: int = MAX_ROUNDS,
                              bill_nodes: int | torch.Tensor | None = None,
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, WorkCounters]:
    """``forest_cleanup_rounds`` threading the log-row table. Unlike it,
    every row is checked and hooked: callers may pass rows masked in
    place, which are not a prefix. ``true_edges`` (an int or a 0-d
    tensor) is what each round bills; ``bill_nodes`` replaces |V| in the
    compress billing."""
    if true_edges is None:
        true_edges = edges.shape[0]
    n = pi.shape[0]
    rounds = 0
    done = edges_consistent(pi, edges)
    if done:
        return pi, parents, parent_eidx, work
    pbuf, ebuf = _with_sentinel(parents), _with_sentinel(parent_eidx)
    sweeps = 0
    while not done and rounds < max_rounds:
        pi, hi, rec = _forest_hook(pi, edges, lift_steps)
        _record_rows_(pbuf, hi, rec, edges)
        _record_rows_(ebuf, hi, rec, edge_ids)
        pi, k = jacobi_sweeps(pi, compress_fuel(n))
        sweeps += k
        done = edges_consistent(pi, edges)
        rounds += 1
    work = work.add(hook_ops=true_edges * (1 + lift_steps) * rounds,
                    hook_rounds=rounds, jump_sweeps=sweeps,
                    jump_ops=_sweep_bill(n, bill_nodes, sweeps))
    return pi, pbuf[:n], ebuf[:n], work


def forest_scan_fits_l2(num_nodes: int, l2_bytes: int) -> bool:
    """Whether π and its Jacobi double buffer, 8 B a vertex, fit in an
    L2 of ``l2_bytes``: the gate of ``forest_segment_scan_ids``'s device
    loop.

    The gate is not where the device loop stops paying: on an H100 it
    ran usa-osm's skeleton scan (23,990,404 vertices, π in device
    memory, 117,321 sweeps) in 9.4 s against the host loop's 69.4 s.
    It is where the forest route is the right route. A graph this
    sparse and this large (a road network) reaches that route only
    because the delete policy's |E| counts inserts and never deletes
    (as the reference's does, which parity pins), and there a faster
    forest tick lets more forest ticks into a stream: a device loop on
    such a graph raised a churning session's tick p90 ~17x. The host
    loop can go, and this gate with it, once the policy counts the
    deletes or a workload takes the forest route beyond the L2 on its
    own."""
    return 8 * num_nodes <= l2_bytes


def forest_scan_loop(num_nodes: int, device) -> str:
    """Where ``forest_segment_scan_ids`` runs its sweeps over ``num_nodes``
    vertices on ``device``: ``"device"`` (one cooperative launch of the
    fused kernel's forest body) on CUDA when ``forest_scan_fits_l2``
    holds for the card's L2, else ``"host"`` (a flag read after each
    sweep)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "host"
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return "device" if forest_scan_fits_l2(num_nodes, l2) else "host"


def forest_segment_scan_ids(pi: torch.Tensor, parents: torch.Tensor,
                            parent_eidx: torch.Tensor, edges: torch.Tensor,
                            edge_ids: torch.Tensor, segment_size: int,
                            work: WorkCounters, true_counts: torch.Tensor,
                            lift_steps: int = 2,
                            bill_nodes: int | torch.Tensor | None = None,
                            span=None,
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, WorkCounters]:
    """``forest_segment_scan`` threading the log-row table (the forest
    rebuild over the surviving EdgeLog and the skeleton phase of the
    tree-aware delete). Segment i is the rows of ``edges`` [R, 2] and
    ``edge_ids`` [R] from ``i * segment_size`` on; only its first
    ``true_counts`` rows are hooked (see above). The tables are recorded
    in place into one sentinel-extended copy for the whole scan, and the
    counters added once at its end.

    Where ``forest_scan_loop`` says ``"device"``, the whole scan is one
    launch (``fused_forest_scan``) that keeps each segment's sweep count
    on the device; the host reads their sum once (``read.scan_sweeps``).
    Elsewhere the host drives it. On CUDA, once a full segment has run
    eagerly, the full segments replay as CUDA graphs
    (``_GraphedSegment``): the same ops, with the host issuing a few
    replays a segment instead of some forty launches. Results and
    counters are the same either way; ``span``, the caller's phase span
    if given, is tagged with the loop."""
    n = pi.shape[0]
    fuel = compress_fuel(n)
    pbuf, ebuf = _with_sentinel(parents), _with_sentinel(parent_eidx)
    # the callers size the segments on the host: a host tensor's list is
    # no read of the device
    if true_counts.device != pi.device:
        counts = true_counts.tolist()
    else:
        counts = obs.read("forest_counts", lambda: true_counts.tolist())
    loop = forest_scan_loop(n, pi.device)
    if span is not None:
        span.tag(loop=loop)
    if loop == "device":
        from repro_torch.kernels.cc_fused.ops import fused_forest_scan
        pi, seg_sweeps = fused_forest_scan(
            pi, pbuf[:n], ebuf[:n], edges, edge_ids,
            torch.tensor(counts, dtype=torch.int32),
            segment_size=segment_size, lift_steps=lift_steps, fuel=fuel)
        sweeps = obs.read("scan_sweeps", lambda: int(seg_sweeps.sum()))
    else:
        pi, sweeps = _forest_scan_host(pi, pbuf, ebuf, edges, edge_ids,
                                       segment_size, counts, lift_steps,
                                       fuel)
    work = work.add(hook_ops=sum(counts) * (1 + lift_steps),
                    hook_rounds=len(counts), jump_sweeps=sweeps,
                    jump_ops=_sweep_bill(n, bill_nodes, sweeps))
    return pi, pbuf[:n], ebuf[:n], work


def _forest_scan_host(pi: torch.Tensor, pbuf: torch.Tensor,
                      ebuf: torch.Tensor, edges: torch.Tensor,
                      edge_ids: torch.Tensor, size: int, counts: list,
                      lift_steps: int, fuel: int) -> tuple[torch.Tensor, int]:
    """The host loop of ``forest_segment_scan_ids`` over sentinel-extended
    tables: returns (π, the sweeps run)."""
    sweeps = 0
    step = None
    for i, cnt in enumerate(counts):
        seg = edges[i * size:i * size + cnt]
        ids = edge_ids[i * size:i * size + cnt]
        full = cnt == size
        if step is not None and full:
            sweeps += step(seg, ids, fuel)
            continue
        if cnt:
            pi, hi, rec = _forest_hook(pi, seg, lift_steps)
            _record_rows_(pbuf, hi, rec, seg)
            _record_rows_(ebuf, hi, rec, ids)
        pi, k = jacobi_sweeps(pi, fuel)
        sweeps += k
        if step is not None:
            step.pi.copy_(pi)
        elif full and pi.is_cuda:
            step = _GraphedSegment(pi, pbuf, ebuf, cnt, lift_steps)
        if step is not None:
            pi = step.pi
    return pi, sweeps


class _GraphedSegment:
    """One full segment of ``forest_segment_scan_ids`` as two CUDA
    graphs over static buffers: the id-recording hook (into the scan's
    tables) and one Jacobi sweep with its changed flag. A call copies
    the segment in, replays the hook, then replays the sweep and reads
    the flag back until nothing changes or ``fuel`` sweeps ran, exactly
    as ``jacobi_sweeps`` counts. ``pi`` holds π between calls. Captured
    by hand on a side stream, so no capture collects garbage or empties
    the allocator's cache."""

    def __init__(self, pi: torch.Tensor, pbuf: torch.Tensor,
                 ebuf: torch.Tensor, rows: int, lift_steps: int):
        dev = pi.device
        self.pi = pi.clone()
        self.edges = torch.zeros((rows, 2), dtype=torch.int32, device=dev)
        self.ids = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self.changed = torch.zeros((), dtype=torch.bool, device=dev)

        def hook():
            new_pi, hi, rec = _forest_hook(self.pi, self.edges, lift_steps)
            _record_rows_(pbuf, hi, rec, self.edges)
            _record_rows_(ebuf, hi, rec, self.ids)
            self.pi.copy_(new_pi)

        def sweep():
            nxt = self.pi[self.pi]
            self.changed.copy_((nxt != self.pi).any())
            self.pi.copy_(nxt)

        self.hook, self.sweep = self._capture(hook), self._capture(sweep)

    @staticmethod
    def _capture(fn) -> "torch.cuda.CUDAGraph":
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            fn()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return graph

    def __call__(self, seg: torch.Tensor, ids: torch.Tensor,
                 fuel: int) -> int:
        self.edges.copy_(seg)
        self.ids.copy_(ids)
        self.hook.replay()
        sweeps = 0
        while sweeps < fuel:
            self.sweep.replay()
            sweeps += 1
            if not obs.read("sweep", lambda: bool(self.changed)):
                break
        return sweeps


def forest_scan_rounds_ids(pi: torch.Tensor, parents: torch.Tensor,
                           parent_eidx: torch.Tensor, packed: torch.Tensor,
                           packed_ids: torch.Tensor, n_true: int,
                           work: WorkCounters, *, lift_steps: int = 2,
                           max_rounds: int = MAX_ROUNDS,
                           bill_nodes: int | torch.Tensor | None = None,
                           segment_size: int = 512, span=None,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, WorkCounters]:
    """The work-efficient drive of the id-recording hook over a packed
    (true-prefix) edge list: one segment-scan pass in ``segment_size``
    row segments of the stored rows (each true row billed once, a full
    compress after each segment; ``span`` as there), then the fixpoint
    cleanup loop, which after the scan usually short-circuits before
    billing anything."""
    cap = packed.shape[0]
    seg = min(segment_size, cap)
    num_segments = -(-cap // seg) if cap else 0
    starts = torch.arange(num_segments, dtype=torch.int32) * seg
    counts = torch.clamp(n_true - starts, 0, seg)
    pi, parents, parent_eidx, work = forest_segment_scan_ids(
        pi, parents, parent_eidx, packed, packed_ids, seg, work, counts,
        lift_steps=lift_steps, bill_nodes=bill_nodes, span=span)
    return forest_cleanup_rounds_ids(
        pi, parents, parent_eidx, packed[:n_true], packed_ids[:n_true], work,
        true_edges=n_true, lift_steps=lift_steps, max_rounds=max_rounds,
        bill_nodes=bill_nodes)


def pack_edge_rows(edges: torch.Tensor, edge_ids: torch.Tensor,
                   mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pack the rows under ``mask`` to a dense prefix, in order; the tail
    becomes (0, 0) rows with id -1. Returns ``(packed_edges, packed_ids,
    true_count)``, the count a host int (the reference's is a device
    scalar; the loops here read it anyway)."""
    idx = obs.read("pack", lambda: mask.nonzero()).squeeze(1)
    n = idx.shape[0]
    packed = torch.zeros_like(edges)
    packed[:n] = edges[idx]
    ids = torch.full_like(edge_ids, -1)
    ids[:n] = edge_ids[idx]
    return packed, ids, n


def forest_scoped_rounds(pi: torch.Tensor, parents: torch.Tensor,
                         parent_eidx: torch.Tensor, edges: torch.Tensor,
                         edge_ids: torch.Tensor, edge_mask: torch.Tensor,
                         forest_keep: torch.Tensor,
                         vertex_mask: torch.Tensor, work: WorkCounters, *,
                         max_rounds: int = MAX_ROUNDS,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    WorkCounters]:
    """Tree-aware scoped reconnection: relabel only the components that
    lost a spanning-forest edge, in two phases billing O(V_aff +
    crossing) rather than O(E_aff):

    1. **skeleton**: hook + compress over the surviving forest edges of
       the affected components (``forest_keep``), packed and scanned in
       1024-row segments (its span tagged with ``rows``, ``segments``
       and ``loop``, where the sweeps run: ``forest_scan_loop``);
    2. **replacement search**: only the alive scoped edges whose
       endpoints still disagree after phase 1 (crossing edges) can
       reconnect fragments; they are hooked to a fixpoint, recording
       the replacement edges into the forest.

    Affected vertices restart as self-roots with their forest rows
    cleared; the others keep labels and forest rows. Both phases hook
    unlifted (``lift_steps=0``), as the reference does.

    The reference masks the crossing rows in place over the whole log;
    here they are packed first (same order), which changes no result:
    a masked (0, 0) row is a no-op that never wins."""
    n_v = pi.shape[0]
    dev = pi.device
    bill_nodes = vertex_mask.sum(dtype=torch.int32)
    pi0 = torch.where(vertex_mask,
                      torch.arange(n_v, dtype=torch.int32, device=dev), pi)
    parents0 = torch.where(vertex_mask[:, None], -1, parents)
    eidx0 = torch.where(vertex_mask, -1, parent_eidx)

    with obs.span("dyn.forest.skeleton") as sp:
        skel, skel_ids, n_skel = pack_edge_rows(parents, parent_eidx,
                                                forest_keep)
        sp.tag(rows=n_skel, segments=-(-skel.shape[0] // 1024))
        pi1, parents1, eidx1, work = forest_scan_rounds_ids(
            pi0, parents0, eidx0, skel, skel_ids, n_skel, work,
            lift_steps=0, max_rounds=max_rounds, bill_nodes=bill_nodes,
            segment_size=1024, span=sp)

    with obs.span("dyn.forest.replace") as sp:
        crossing = edge_mask & (pi1[edges[:, 0]] != pi1[edges[:, 1]])
        c_edges, c_ids, n_cross = pack_edge_rows(edges, edge_ids, crossing)
        sp.tag(rows=n_cross)
        return forest_cleanup_rounds_ids(
            pi1, parents1, eidx1, c_edges[:n_cross], c_ids[:n_cross], work,
            true_edges=n_cross, lift_steps=0, max_rounds=max_rounds,
            bill_nodes=bill_nodes)


# ---------------------------------------------------------------------------
# Scoped recompute (the plain delete fallback)
# ---------------------------------------------------------------------------

def scoped_rounds(pi: torch.Tensor, edges: torch.Tensor,
                  edge_mask: torch.Tensor, vertex_mask: torch.Tensor,
                  plan: SegmentationPlan, ops: RoundOps,
                  work: WorkCounters, max_rounds: int = MAX_ROUNDS,
                  ) -> tuple[torch.Tensor, WorkCounters]:
    """Scoped recompute: re-derive labels for ONLY the vertices under
    ``vertex_mask`` from the edges under ``edge_mask``, leaving every
    other label untouched (the delete fallback of the fully-dynamic
    engine: ``vertex_mask`` marks the components a retired edge may
    have split, ``edge_mask`` their surviving edges).

    The masked edges are packed, in order, to a (0, 0)-padded prefix
    and run through the Fig. 4 pipeline: the segment scan over ``plan``
    (segments of the stored rows, billed on the packed count), then the
    cleanup loop. Affected vertices restart as self-roots. Callers pass
    ``ops`` built with ``bill_nodes`` = the affected-vertex count.

    With fused ops the scan is one kernel launch over the padded
    segments. With torch ops only each segment's true prefix is hooked,
    and the cleanup covers the packed rows only: every hook here runs
    over a compressed π, where a (0, 0) row is a no-op, so the result
    and the billing are the reference's without the padding rows'
    writes all landing on one address."""
    n_v = pi.shape[0]
    dev = pi.device
    idx = obs.read("scoped_rows", lambda: edge_mask.nonzero()).squeeze(1)
    n_scoped = idx.shape[0]
    packed = edges[idx]
    pi0 = torch.where(vertex_mask,
                      torch.arange(n_v, dtype=torch.int32, device=dev), pi)
    counts = segment_true_counts(n_scoped, plan, device=dev)
    if ops.scan is not None:
        segments = pad_and_segment(packed, plan)
        pi1, work = ops.scan(pi0, segments, counts, work)
    else:
        pi1, seg = pi0, plan.segment_size
        for i, cnt in enumerate(
                obs.read("scoped_counts", lambda: counts.tolist())):
            if cnt:
                pi1 = ops.hook(pi1, packed[i * seg:i * seg + cnt])
            work = work.add(hook_ops=cnt * ops.bill_lift, hook_rounds=1)
            pi1, work = ops.compress(pi1, work)
    return cleanup_rounds(pi1, packed, ops, work, true_edges=n_scoped,
                          max_rounds=max_rounds)
