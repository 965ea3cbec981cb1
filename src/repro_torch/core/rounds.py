"""Adaptive hook+compress round machinery of ``repro.core.rounds``, on
torch tensors.

Deterministic Hook (scatter-min with bounded root chase), Compress
(Jacobi pointer doubling to a fixpoint), the work counters, and the
paper's Fig. 4 composition as one loop over segments (``segment_scan``)
and one over cleanup rounds (``cleanup_rounds``). The rest composes
those two: the adaptive pipeline, its forest-recording forms and the
dynamic engine's scoped recomputes (``scoped_rounds``, and
``forest_scoped_rounds`` for the tree-aware delete).

The loops read one seam, ``RoundOps``: how a round hooks and compresses,
what a winning hook records, and where a scan runs. The plain ops
(``torch_round_ops``, ``pallas_round_ops``, ``fused_round_ops``) record
nothing. Recording ops (``forest_round_ops``) record each retired
root's winning edge, and given a log-row table its row, in place into
one sentinel-extended copy of the tables; ``ops.tables()`` hands them
back. (The reference writes a forest copy of each composition: a
jitted program needs one signature per carry.) The fused ops run a
scan, or a cleanup round, in one launch of K1; recording ops built for
an id-recording scan run it in one launch of K1's forest body or on the
host (``forest_scan_loop``); every other loop is driven by the host,
which reads the loop's condition back once per iteration, where the
reference runs ``lax.while_loop``/``lax.scan`` in one jitted program.

``WorkCounters`` still bill exactly what the reference bills —
``sync_rounds`` counts the reference's host-equivalent synchronisation
points, not the host reads this eager loop makes — so the counters of
both packages compare equal field by field (below 2^31, where the
reference's int32 counters wrap). A host-driven loop adds its counts up
on the host and bills them once, at its end. Work bills *true* edge
counts: padded ``(0, 0)`` no-op edges are never counted. Counters are
0-d int64 tensors on the graph's device, exact past 2^31, where a graph
of 174M vertices bills |V| a sweep and 3 hook_ops an edge a pass.

The reads are counted by ``obs.read`` under ``read.<site>``: the
segment scan reads its counts once, under the site its caller names
(``scan_counts``, ``scoped_counts``, ``forest_counts``; none where the
host planned them), and each compress sweep its changed flag
(``sweep``); the cleanup loop reads its consistency before the first
round and after each (``consistent``); a one-launch id-recording scan
reads its sweep sum (``scan_sweeps``) and no flag; ``scoped_rows`` and
``pack`` are the ``nonzero`` packs that size loops and buffers. The
Fig. 4 pipeline runs under the spans ``cc.scan`` and ``cc.cleanup``
(tagged with the Jacobi ``sweeps`` they ran, and ``cc.cleanup`` with its
hook ``rounds``, from the host's counts of those reads), the tree-aware
delete under ``dyn.forest.skeleton`` and ``dyn.forest.replace``; on
torch ops each ends on a read, so its host time is the phase's wall
time (a fused scan is one launch that reads nothing back).
"""
from __future__ import annotations

import functools
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
            elif not v:
                continue            # adding 0 launches nothing
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
    |V|) each: an int64 tensor when ``bill_nodes`` is a tensor and
    sweeps ran, else an int."""
    if not sweeps:
        return 0
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
    """The seam ``segment_scan`` and ``cleanup_rounds`` read.

    * ``hook(pi, edges[, edge_ids]) -> pi`` — one hook pass over an edge
      set (recording ops with a log-row table also take the rows' ids),
    * ``compress(pi) -> (pi, sweeps)`` — full compress and the Jacobi
      sweeps it ran (0 where a kernel does not count them),
    * ``bill_lift`` — hook evaluations billed per true edge
      (1 + lift_steps),
    * ``scan`` — optional, ``scan(pi, rows, segment_size, true_counts,
      work, edge_ids) -> (pi, work)``: the whole segment scan in one
      launch, billing internally (the fused ops also run each cleanup
      round as one),
    * ``bill_nodes`` — jump_ops billed per sweep in place of |V| (an int
      or an integer 0-d tensor: a scoped recompute's affected count),
    * ``tables`` — recording ops only: ``tables()`` is the recorded
      ``(parents,)`` or ``(parents, parent_eidx)``, at [V].
    """

    hook: Callable[..., torch.Tensor]
    compress: Callable[[torch.Tensor], tuple[torch.Tensor, int]]
    bill_lift: int
    scan: Callable[..., tuple[torch.Tensor, WorkCounters]] | None = None
    bill_nodes: int | torch.Tensor | None = None
    tables: Callable[[], tuple[torch.Tensor, ...]] | None = None


# counters of host ints: ``compress`` into them tallies on the host
_HOST_TALLY = WorkCounters(0, 0, 0, 0, 0)


def _compress_sweeps(pi: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``compress`` with no device op for its billing: (π, the sweeps it
    ran), which the calling loop bills."""
    pi, tally = compress(pi, _HOST_TALLY)
    return pi, tally.jump_sweeps


def torch_round_ops(lift_steps: int = 2,
                    bill_nodes: int | torch.Tensor | None = None
                    ) -> RoundOps:
    """Plain torch ops (the default backend; the reference's
    ``jnp_round_ops``). ``bill_nodes`` (an int or an integer 0-d tensor)
    replaces |V| as the jump_ops billed per compress sweep: the scoped
    recompute bills its affected-vertex count."""
    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=_compress_sweeps,
        bill_lift=1 + lift_steps,
        bill_nodes=bill_nodes,
    )


def pallas_round_ops(lift_steps: int, node_tile: int) -> RoundOps:
    """Per-round kernel ops (backend ``pallas``): the ``hook`` kernel at
    one tile per edge set (every edge hooks from one π snapshot, as
    ``hook_edges`` does) and the ``multi_jump`` compress kernel. The
    compress kernel does not count its sweeps, so none are billed, as
    in the reference."""
    from repro_torch.kernels.hook.ops import hook_edges_snapshot
    from repro_torch.kernels.multi_jump.ops import full_compress
    return RoundOps(
        hook=lambda pi, e: hook_edges_snapshot(pi, e, lift_steps=lift_steps),
        compress=lambda pi: (full_compress(pi, tile=node_tile), 0),
        bill_lift=1 + lift_steps,
    )


def fused_round_ops(lift_steps: int = 2,
                    bill_nodes: int | torch.Tensor | None = None
                    ) -> RoundOps:
    """Fused-kernel ops (backend ``pallas_fused``, ``kernels.cc_fused``):
    the whole segment scan in ONE kernel launch, over the rows padded
    with (0, 0) to whole segments. Billing is bit-equal to the torch-ops
    backend: hook_ops on TRUE per-segment counts, jump_sweeps from the
    kernel's per-segment sweep counts, jump_ops ``bill_nodes`` (default
    |V|) per sweep."""
    from repro_torch.kernels.cc_fused.ops import fused_segment_scan
    bill = 1 + lift_steps

    def scan(pi, rows, segment_size, true_counts, work, edge_ids=None):
        num = true_counts.shape[0]
        pad = num * segment_size - rows.shape[0]
        if pad > 0:
            rows = torch.cat([rows, rows.new_zeros((pad, 2))])
        v = pi.shape[0] if bill_nodes is None else bill_nodes
        pi, sweeps = fused_segment_scan(
            pi, rows.reshape(num, segment_size, 2), true_counts,
            lift_steps=lift_steps)
        total = sweeps.sum(dtype=torch.int64)
        return pi, work.add(
            hook_ops=true_counts.sum(dtype=torch.int64) * bill,
            hook_rounds=num,
            jump_ops=total * (v.to(torch.int64)
                              if isinstance(v, torch.Tensor) else v),
            jump_sweeps=total)

    return RoundOps(
        hook=lambda pi, e: hook_edges(pi, e, lift_steps=lift_steps),
        compress=_compress_sweeps,
        bill_lift=bill,
        scan=scan,
        bill_nodes=bill_nodes,
    )


# ---------------------------------------------------------------------------
# Recording ops (the spanning forest as a by-product of hook rounds)
# ---------------------------------------------------------------------------
# Every hook round runs over a fully compressed π, so a scatter-min write
# at ``hi`` strictly lowers a root's own label (π[hi] == hi before, lo <
# hi after) and hi never reappears as a label. Each row is recorded at
# most once over the run, each recorded edge merges two components that
# were distinct when it was recorded, and the recorded rows are a
# spanning forest: V - C edges, one unrecorded root (the component
# minimum) per component. ``parent_eidx[r]`` is the log row of the edge
# at ``parents[r]`` (-1 for roots), which lets a delete batch classify
# tree and non-tree hits with one O(V) gather. Over a compressed π a
# (0, 0) row (id -1) is a no-op that never wins, so the loops leave out
# rows known to be such padding, which changes no result.

_INT32_MAX = 2**31 - 1


def empty_forest(num_nodes: int, device=None) -> torch.Tensor:
    """int32 [V, 2] parent-edge table, all (-1, -1): row r will hold the
    graph edge whose hook retired root r; rows still (-1, -1) at the end
    are the component roots."""
    return torch.full((num_nodes, 2), -1, dtype=torch.int32, device=device)


def empty_forest_idx(num_nodes: int, device=None) -> torch.Tensor:
    """int32 [V] log-row table matching ``empty_forest``: all -1."""
    return torch.full((num_nodes,), -1, dtype=torch.int32, device=device)


def _forest_hook(pi: torch.Tensor, edges: torch.Tensor, lift_steps: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forest hook: ``hook_edges``'s π update, plus which edge wins
    each retired root. Returns (new π, ``hi`` int64 [E], ``rec`` bool
    [E] marking the one winning row per retired root).

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
    row (``mode="drop"`` at index V)."""
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


def _with_sentinel(table: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with one more row: the sentinel row that
    ``_record_rows_`` sends the losing rows to."""
    return torch.cat([table, table.new_full((1,) + table.shape[1:], -1)])


def _record_rows_(buf: torch.Tensor, hi: torch.Tensor, rec: torch.Tensor,
                  values: torch.Tensor) -> None:
    """In place on a sentinel-extended table: ``buf[hi[i]] = values[i]``
    for the rows under ``rec``, the others to the last row (sliced off
    at the end, so no index past a buffer reaches a scatter)."""
    buf.index_put_((torch.where(rec, hi, buf.shape[0] - 1),), values)


def forest_scan_fits_l2(num_nodes: int, l2_bytes: int) -> bool:
    """Whether π and its Jacobi double buffer, 8 B a vertex, fit in an
    L2 of ``l2_bytes``: the gate of the id-recording scan's device loop.

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
    """Where an id-recording scan runs its sweeps over ``num_nodes``
    vertices on ``device``: ``"device"`` (one cooperative launch of the
    fused kernel's forest body) on CUDA when ``forest_scan_fits_l2``
    holds for the card's L2, else ``"host"`` (a flag read after each
    sweep)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "host"
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return "device" if forest_scan_fits_l2(num_nodes, l2) else "host"


def forest_round_ops(parents: torch.Tensor,
                     parent_eidx: torch.Tensor | None = None, *,
                     lift_steps: int = 2,
                     bill_nodes: int | torch.Tensor | None = None,
                     segment_size: int | None = None) -> RoundOps:
    """Recording ops over ``parents`` [V, 2] and, if given,
    ``parent_eidx`` [V] (the hook then takes the rows' log ids): the
    forest hook (``_forest_hook``) with ``lift_steps``, recording each
    retired root's winning edge and row in place, into one
    sentinel-extended copy of the tables made at the first hook (ops
    that never hook hand the caller's tables back). Compress and billing
    are ``torch_round_ops``'s.

    With ``segment_size`` and ``parent_eidx`` the ops are built for one
    id-recording scan in segments of that many rows, and
    ``forest_scan_loop`` picks where its sweeps run: on ``"device"``
    ``scan`` is one launch of K1's forest body, which keeps each
    segment's sweep count on the device and has the host read their sum
    once (``read.scan_sweeps``); on ``"host"`` on CUDA, once a full
    segment has run eagerly, the full segments replay as CUDA graphs
    (``_GraphedSegment``): the same ops, with the host issuing a few
    replays a segment instead of some forty launches. Results and
    counters are the same on every loop."""
    rec = _Recorder(parents, parent_eidx, lift_steps, bill_nodes,
                    segment_size)
    scan = None
    if segment_size is not None and \
            forest_scan_loop(parents.shape[0], parents.device) == "device":
        from repro_torch.kernels.cc_fused.ops import fused_forest_scan
        scan = functools.partial(rec.scan, fused_forest_scan)
    return RoundOps(hook=rec.hook, compress=rec.compress,
                    bill_lift=1 + lift_steps, scan=scan,
                    bill_nodes=bill_nodes, tables=rec.tables)


class _Recorder:
    """The state behind one recording ops object: the caller's tables,
    their sentinel-extended copy (made at the first hook), and on a
    scan's host loop on CUDA the graphs of a full segment, with which of
    the hook's and compress's calls they serve."""

    def __init__(self, parents, parent_eidx, lift_steps, bill_nodes,
                 segment_size):
        self.given = (parents,) if parent_eidx is None \
            else (parents, parent_eidx)
        self.lift_steps, self.bill_nodes = lift_steps, bill_nodes
        self.size = segment_size
        self.bufs = None
        self.step = None        # the graphs, once a full segment ran
        self.full = False       # the last eager hook took a full segment
        self.graphed = False    # the last hook replayed the graph

    def buffers(self) -> tuple[torch.Tensor, ...]:
        if self.bufs is None:
            self.bufs = tuple(_with_sentinel(t) for t in self.given)
        return self.bufs

    def tables(self) -> tuple[torch.Tensor, ...]:
        if self.bufs is None:
            return self.given
        n = self.given[0].shape[0]
        return tuple(b[:n] for b in self.bufs)

    def hook(self, pi, edges, edge_ids=None):
        rows = edges.shape[0]
        if self.step is not None and rows == self.size:
            self.graphed = True
            return self.step.hook(edges, edge_ids)
        new_pi, hi, rec = _forest_hook(pi, edges, self.lift_steps)
        for buf, values in zip(self.buffers(), (edges, edge_ids)):
            _record_rows_(buf, hi, rec, values)
        self.full = rows == self.size
        return new_pi

    def compress(self, pi):
        if self.graphed:
            self.graphed = False
            return pi, self.step.sweeps(compress_fuel(pi.shape[0]))
        pi, sweeps = _compress_sweeps(pi)
        if self.step is not None:
            self.step.pi.copy_(pi)
        elif self.full and pi.is_cuda:
            self.step = _GraphedSegment(pi, self.buffers(), self.size,
                                        self.lift_steps)
        if self.step is not None:
            pi = self.step.pi
        self.full = False
        return pi, sweeps

    def scan(self, kernel, pi, rows, segment_size, true_counts, work,
             edge_ids):
        """The whole scan in one launch of ``kernel``
        (``fused_forest_scan``), over host ``true_counts``."""
        n = pi.shape[0]
        pbuf, ebuf = self.buffers()
        pi, seg_sweeps = kernel(pi, pbuf[:n], ebuf[:n], rows, edge_ids,
                                true_counts, segment_size=segment_size,
                                lift_steps=self.lift_steps,
                                fuel=compress_fuel(n))
        sweeps = obs.read("scan_sweeps", lambda: int(seg_sweeps.sum()))
        counts = true_counts.tolist()
        return pi, _bill(work, 1 + self.lift_steps, self.bill_nodes, n,
                         sum(counts), len(counts), sweeps)


class _GraphedSegment:
    """One full segment of an id-recording scan's host loop as two CUDA
    graphs over static buffers: the id-recording hook (into the scan's
    tables) and one Jacobi sweep with its changed flag. ``hook`` copies
    the segment in and replays the hook; ``sweeps`` replays the sweep
    and reads the flag back until nothing changes or ``fuel`` sweeps
    ran, exactly as ``jacobi_sweeps`` counts. ``pi`` holds π between
    calls. Captured by hand on a side stream, so no capture collects
    garbage or empties the allocator's cache."""

    def __init__(self, pi: torch.Tensor, bufs: tuple, rows: int,
                 lift_steps: int):
        dev = pi.device
        self.pi = pi.clone()
        self.edges = torch.zeros((rows, 2), dtype=torch.int32, device=dev)
        self.ids = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self.changed = torch.zeros((), dtype=torch.bool, device=dev)

        def hook():
            new_pi, hi, rec = _forest_hook(self.pi, self.edges, lift_steps)
            for buf, values in zip(bufs, (self.edges, self.ids)):
                _record_rows_(buf, hi, rec, values)
            self.pi.copy_(new_pi)

        def sweep():
            nxt = self.pi[self.pi]
            self.changed.copy_((nxt != self.pi).any())
            self.pi.copy_(nxt)

        self._hook, self._sweep = self._capture(hook), self._capture(sweep)

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

    def hook(self, seg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        self.edges.copy_(seg)
        self.ids.copy_(ids)
        self._hook.replay()
        return self.pi

    def sweeps(self, fuel: int) -> int:
        sweeps = 0
        while sweeps < fuel:
            self._sweep.replay()
            sweeps += 1
            if not obs.read("sweep", lambda: bool(self.changed)):
                break
        return sweeps


def hook_edges_forest(pi: torch.Tensor, parents: torch.Tensor,
                      edges: torch.Tensor, lift_steps: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``hook_edges`` plus spanning-forest recording (same π update):
    one hook of recording ops over ``parents``. Returns (new π, the new
    table); ``parents`` is not written."""
    ops = forest_round_ops(parents, lift_steps=lift_steps)
    return ops.hook(pi, edges.reshape(-1, 2)), ops.tables()[0]


def hook_edges_forest_ids(pi: torch.Tensor, parents: torch.Tensor,
                          parent_eidx: torch.Tensor, edges: torch.Tensor,
                          edge_ids: torch.Tensor, lift_steps: int = 0,
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``hook_edges_forest`` plus external-id recording: the same π
    update and the same tie-break (the lowest batch slot wins), and the
    winning slot's ``edge_ids`` entry lands in ``parent_eidx``."""
    ops = forest_round_ops(parents, parent_eidx, lift_steps=lift_steps)
    pi = ops.hook(pi, edges.reshape(-1, 2), edge_ids.reshape(-1))
    return (pi, *ops.tables())


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
# Round composition (Fig. 4): the one segment scan and the one cleanup loop
# ---------------------------------------------------------------------------

def _bill(work: WorkCounters, bill_lift: int, bill_nodes, num_nodes: int,
          true_rows: int, rounds: int, sweeps: int) -> WorkCounters:
    """A host-driven loop's counts, added once at its end: ``true_rows``
    hook evaluations of ``bill_lift`` each over ``rounds`` hook rounds,
    and ``sweeps`` compress sweeps of ``bill_nodes`` (default |V|)."""
    return work.add(hook_ops=true_rows * bill_lift, hook_rounds=rounds,
                    jump_sweeps=sweeps,
                    jump_ops=_sweep_bill(num_nodes, bill_nodes, sweeps))


def segment_scan(pi: torch.Tensor, segments: torch.Tensor, ops: RoundOps,
                 work: WorkCounters,
                 true_counts: torch.Tensor | None = None, *,
                 segment_size: int | None = None,
                 edge_ids: torch.Tensor | None = None,
                 site: str = "scan_counts",
                 ) -> tuple[torch.Tensor, WorkCounters]:
    """Fig. 4 inner structure: for each segment, hook then fully
    compress. The port's one loop over segments.

    ``segments`` [S, seg, 2] hooks each segment whole, as the reference
    does, and ``true_counts`` ([S] int32; None: the full size) bills
    hook_ops on true edges only. With ``segment_size``, ``segments`` is
    instead the rows [R, 2] of a packed list: segment i is the
    ``true_counts[i]`` rows from row ``i * segment_size`` on, and only
    those are hooked (over a compressed π a (0, 0) row is a no-op, so
    the result is the same); ``edge_ids`` [R] are their log ids, for
    ops that record them. ``site`` names the read of the counts, which
    is no read of the device where they are on the host and π is not.

    Ops with a ``scan`` run it in one launch. Otherwise the host drives
    the loop and bills its counts once, at its end."""
    whole = segment_size is None
    if whole:
        num, segment_size = segments.shape[:2]
        segments = segments.reshape(-1, 2)
        if true_counts is None:
            true_counts = torch.full((num,), segment_size,
                                     dtype=torch.int32,
                                     device=segments.device)
    if ops.scan is not None:
        return ops.scan(pi, segments, segment_size, true_counts, work,
                        edge_ids)
    if true_counts.device != pi.device:
        counts = true_counts.tolist()
    else:
        counts = obs.read(site, lambda: true_counts.tolist())
    sweeps = 0
    for i, cnt in enumerate(counts):
        start = i * segment_size
        rows = slice(start, start + (segment_size if whole else cnt))
        if whole or cnt:
            pi = ops.hook(pi, segments[rows], *_ids(edge_ids, rows))
        pi, k = ops.compress(pi)
        sweeps += k
    return pi, _bill(work, ops.bill_lift, ops.bill_nodes, pi.shape[0],
                     sum(counts), len(counts), sweeps)


def _ids(edge_ids: torch.Tensor | None, rows: slice) -> tuple:
    return () if edge_ids is None else (edge_ids[rows],)


def cleanup_rounds(pi: torch.Tensor, edges: torch.Tensor, ops: RoundOps,
                   work: WorkCounters,
                   true_edges: int | None = None,
                   max_rounds: int = MAX_ROUNDS, *,
                   edge_ids: torch.Tensor | None = None,
                   ) -> tuple[torch.Tensor, WorkCounters]:
    """Re-hook ``edges`` until every edge is consistent (usually 0-1
    rounds), covering hook candidates dropped by deterministic
    min-selection. The port's one loop over cleanup rounds.

    Only the first ``true_edges`` rows (default: all) are checked and
    hooked: the rest are (0, 0) padding, consistent and a no-op, and
    each round bills the true rows. ``edge_ids`` are the rows' log ids,
    for ops that record them. The initial consistency check
    short-circuits an already consistent edge set to zero hook rounds.
    With fused ops each round is one launch (hook + full compress of the
    edge set as one segment); otherwise the host drives the loop and
    bills its counts once, at its end."""
    if true_edges is None:
        true_edges = edges.shape[0]
    edges = edges[:true_edges]
    ids = _ids(edge_ids, slice(0, true_edges))
    true1 = None if ops.scan is None else torch.tensor(
        [wrap_int32(true_edges)], dtype=torch.int32, device=edges.device)
    rounds = host_rounds = sweeps = 0
    done = edges_consistent(pi, edges)
    while not done and rounds < max_rounds:
        if ops.scan is not None:
            pi, work = ops.scan(pi, edges, true_edges, true1, work, *ids)
        else:
            pi, k = ops.compress(ops.hook(pi, edges, *ids))
            host_rounds += 1
            sweeps += k
        done = edges_consistent(pi, edges)
        rounds += 1
    return pi, _bill(work, ops.bill_lift, ops.bill_nodes, pi.shape[0],
                     true_edges * host_rounds, host_rounds, sweeps)


def adaptive_rounds(edges: torch.Tensor, num_nodes: int,
                    plan: SegmentationPlan, *,
                    ops: RoundOps | None = None,
                    lift_steps: int = 2,
                    true_edges: int | None = None,
                    max_rounds: int = MAX_ROUNDS,
                    ) -> tuple[torch.Tensor, WorkCounters]:
    """The full adaptive pipeline (Fig. 4): segment scan, then cleanup,
    over the rows of ``edges`` in ``plan``'s segments. ``true_edges``
    defaults to ``plan.num_edges``. Returns (labels, work) — callers add
    their own sync_rounds billing."""
    if ops is None:
        ops = torch_round_ops(lift_steps)
    if true_edges is None:
        true_edges = plan.num_edges
    counts = segment_true_counts(true_edges, plan, device=edges.device)
    pi0 = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    with obs.span("cc.scan", segments=plan.num_segments) as sp:
        sweeps0 = _reads("sweep")
        pi, work = segment_scan(pi0, edges, ops,
                                WorkCounters.zeros(edges.device),
                                true_counts=counts,
                                segment_size=plan.segment_size)
        if ops.scan is None:
            sp.tag(sweeps=_reads("sweep") - sweeps0)
    with obs.span("cc.cleanup") as sp:
        sweeps0, checks0 = _reads("sweep"), _reads("consistent")
        pi, work = cleanup_rounds(pi, edges, ops, work,
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
# The forest compositions: the two loops with recording ops
# ---------------------------------------------------------------------------

def forest_adaptive_rounds(edges: torch.Tensor, num_nodes: int,
                           plan: SegmentationPlan, *,
                           lift_steps: int = 2,
                           true_edges: int | None = None,
                           max_rounds: int = MAX_ROUNDS,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      WorkCounters]:
    """``adaptive_rounds`` with the spanning forest recorded along the
    way. Labels and counters equal ``adaptive_rounds``'s."""
    ops = forest_round_ops(empty_forest(num_nodes, edges.device),
                           lift_steps=lift_steps)
    pi, work = adaptive_rounds(edges, num_nodes, plan, ops=ops,
                               true_edges=true_edges, max_rounds=max_rounds)
    return pi, ops.tables()[0], work


def forest_segment_scan_ids(pi: torch.Tensor, parents: torch.Tensor,
                            parent_eidx: torch.Tensor, edges: torch.Tensor,
                            edge_ids: torch.Tensor, segment_size: int,
                            work: WorkCounters, true_counts: torch.Tensor,
                            lift_steps: int = 2,
                            bill_nodes: int | torch.Tensor | None = None,
                            span=None,
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, WorkCounters]:
    """The id-recording segment scan (the forest rebuild over the
    surviving EdgeLog and the skeleton phase of the tree-aware delete):
    ``segment_scan`` over the packed rows ``edges`` [R, 2] and their ids
    ``edge_ids`` [R] in ``segment_size``-row segments, with recording
    ops built for it, which pick the loop (``forest_round_ops``).
    ``true_counts`` are the host's counts (a CPU tensor; on the host
    loop a tensor on π's device is read back under
    ``read.forest_counts``). ``span``, the caller's phase span if given,
    is tagged with the loop."""
    ops = forest_round_ops(parents, parent_eidx, lift_steps=lift_steps,
                           bill_nodes=bill_nodes, segment_size=segment_size)
    if span is not None:
        span.tag(loop="host" if ops.scan is None else "device")
    pi, work = segment_scan(pi, edges, ops, work, true_counts,
                            segment_size=segment_size, edge_ids=edge_ids,
                            site="forest_counts")
    return (pi, *ops.tables(), work)


def forest_scan_rounds_ids(pi: torch.Tensor, parents: torch.Tensor,
                           parent_eidx: torch.Tensor, packed: torch.Tensor,
                           packed_ids: torch.Tensor, n_true: int,
                           work: WorkCounters, *, lift_steps: int = 2,
                           max_rounds: int = MAX_ROUNDS,
                           bill_nodes: int | torch.Tensor | None = None,
                           segment_size: int = 512,
                           num_segments: int | None = None, span=None,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, WorkCounters]:
    """The work-efficient drive of the id-recording hook over a packed
    (true-prefix) edge list: one segment-scan pass
    (``forest_segment_scan_ids``, ``span`` as there) in ``segment_size``
    row segments of the stored rows (each true row billed once, a full
    compress after each segment), then the cleanup loop with recording
    ops, which after the scan usually short-circuits before billing
    anything. ``num_segments`` (default: as many as cover the rows) is
    the scan's count when a plan sets it: the forest rebuild scans its
    plan's segments, trailing empty ones included, as the reference
    does."""
    cap = packed.shape[0]
    seg = max(1, min(segment_size, cap))
    if num_segments is None:
        num_segments = -(-cap // seg)
    starts = torch.arange(num_segments, dtype=torch.int32) * seg
    counts = torch.clamp(n_true - starts, 0, seg)
    pi, parents, parent_eidx, work = forest_segment_scan_ids(
        pi, parents, parent_eidx, packed, packed_ids, seg, work, counts,
        lift_steps=lift_steps, bill_nodes=bill_nodes, span=span)
    ops = forest_round_ops(parents, parent_eidx, lift_steps=lift_steps,
                           bill_nodes=bill_nodes)
    pi, work = cleanup_rounds(pi, packed, ops, work, true_edges=n_true,
                              max_rounds=max_rounds, edge_ids=packed_ids)
    return (pi, *ops.tables(), work)


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
       reconnect fragments; the cleanup loop hooks them to a fixpoint
       with recording ops, recording the replacement edges into the
       forest.

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
        ops = forest_round_ops(parents1, eidx1, lift_steps=0,
                               bill_nodes=bill_nodes)
        pi, work = cleanup_rounds(pi1, c_edges, ops, work,
                                  true_edges=n_cross, max_rounds=max_rounds,
                                  edge_ids=c_ids)
        return (pi, *ops.tables(), work)


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

    The masked edges are packed, in order, and run through the Fig. 4
    pipeline: the segment scan over ``plan``'s segments of the stored
    rows (billed on the packed count; only each segment's packed rows
    are hooked, or with fused ops the rows padded with (0, 0) to whole
    segments in one launch), then the cleanup loop over the packed
    rows. Affected vertices restart as self-roots. Callers pass ``ops``
    built with ``bill_nodes`` = the affected-vertex count."""
    n_v = pi.shape[0]
    dev = pi.device
    idx = obs.read("scoped_rows", lambda: edge_mask.nonzero()).squeeze(1)
    n_scoped = idx.shape[0]
    packed = edges[idx]
    pi0 = torch.where(vertex_mask,
                      torch.arange(n_v, dtype=torch.int32, device=dev), pi)
    pi1, work = segment_scan(
        pi0, packed, ops, work, segment_true_counts(n_scoped, plan,
                                                    device=dev),
        segment_size=plan.segment_size, site="scoped_counts")
    return cleanup_rounds(pi1, packed, ops, work, true_edges=n_scoped,
                          max_rounds=max_rounds)
