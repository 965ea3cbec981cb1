"""Batched connected components: many graphs, one kernel launch per shape
bucket scan (the port of ``repro.core.batch``).

The serving-shaped workload: lots of small and medium graphs (molecule
batches, per-user subgraphs, sampled minibatch blocks) where per-graph
dispatch dominates. Graphs are grouped by their power-of-two
``(V_pad, E_pad)`` bucket and each bucket runs the adaptive Fig. 4
pipeline for all its graphs at once:

  * vertices are padded as self-roots (``pi0 = arange(V_pad)`` per
    graph) and edges with ``(0, 0)`` no-op rows;
  * one segmentation plan per bucket, ``plan_segmentation(E_pad, V_pad,
    num_segments)``;
  * the segment scan of the whole bucket is ONE launch of the fused
    kernel's batched entry (``fused_segment_scan_batched``), and each
    cleanup round one more, over the graphs whose edges are still
    inconsistent; the consistency of every graph is one [B] vector, read
    back once per round.

The reference runs a bucket as its jnp rounds under ``jax.vmap``; its
``while_loop``s stop billing a graph once that graph is done. The port
bills the same way, so per graph the labels AND all five
``WorkCounters`` equal the reference's ``solve_batched``: ``hook_ops``
bills the graph's true edges, ``jump_ops`` its true |V| per sweep, and
each graph gets ``sync_rounds=1``. They are not a per-graph ``solve``'s
counters, because the bucket's padded plan changes the segmentation.

Placement follows the port's rule: host inputs run on ``device`` (CUDA
when None) and come back as CPU tensors, one copy per bucket; a fleet of
``DeviceGraph``s runs on their device and its results stay there.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import rounds
from repro_torch.core.cc import CCResult
from repro_torch.core.rounds import WorkCounters
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import DeviceGraph, next_pow2, resolve_device

_MIN_NODES = 8
_MIN_EDGES = 8


def pad_rows_pow2(arr: np.ndarray, min_rows: int = _MIN_EDGES
                  ) -> np.ndarray:
    """Pad axis 0 with zero rows to a power-of-two count (floored at
    ``min_rows``). Zero rows are no-ops for every query (vertex 0
    against itself)."""
    arr = np.asarray(arr)
    target = next_pow2(max(arr.shape[0], min_rows))
    if target == arr.shape[0]:
        return arr
    pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def bucket_shape(num_nodes: int, num_edges: int) -> tuple[int, int]:
    """The (V_pad, E_pad) bucket a graph lands in: the next powers of
    two, floored at small minima."""
    return (next_pow2(max(num_nodes, _MIN_NODES)),
            next_pow2(max(num_edges, _MIN_EDGES)))


class GraphBatch(NamedTuple):
    """One shape bucket: [B, E_pad, 2] edges plus per-graph true sizes
    (for label truncation and work billing)."""
    edges: np.ndarray | torch.Tensor   # int32 [B, E_pad, 2]
    num_nodes: int                     # V_pad
    true_nodes: np.ndarray             # int32 [B]
    true_edges: np.ndarray             # int32 [B]
    indices: np.ndarray                # int32 [B] positions in the input


def stack_device_graphs(graphs: Sequence[DeviceGraph]) -> list[GraphBatch]:
    """Group ``DeviceGraph``s by their (V_pad, E_pad) bucket (of the
    STORED rows) and stack each bucket's edges on their device, each
    member padded with (0, 0) rows. True counts come from the graphs'
    host metadata; a graph whose count lives on the device (an
    ``EdgeLog`` view) is refused, as the reference refuses one without
    a static count."""
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, g in enumerate(graphs):
        if g.count_on_device:
            raise ValueError("batched execution needs static true "
                             "edge counts (graph %d)" % i)
        buckets.setdefault(
            bucket_shape(g.num_nodes, int(g.edges.shape[0])),
            []).append(i)
    out = []
    for (v_pad, e_pad), members in sorted(buckets.items()):
        stack = torch.stack(
            [graphs[i].pad_rows(e_pad).edges for i in members])
        tn = np.asarray([graphs[i].num_nodes for i in members], np.int32)
        te = np.asarray([graphs[i].true_edges for i in members], np.int32)
        out.append(GraphBatch(edges=stack, num_nodes=v_pad,
                              true_nodes=tn, true_edges=te,
                              indices=np.asarray(members, np.int32)))
    return out


def _host_edges(edges) -> np.ndarray:
    if isinstance(edges, torch.Tensor):
        edges = edges.cpu().numpy()
    return np.asarray(edges, np.int32).reshape(-1, 2)


def bucketize(graphs: Sequence[tuple[np.ndarray, int]]
              ) -> list[GraphBatch]:
    """Group (edges, num_nodes) pairs into shape buckets on the host."""
    buckets: dict[tuple[int, int], list[int]] = {}
    prepped = []
    for i, (edges, n) in enumerate(graphs):
        edges = _host_edges(edges)
        prepped.append((edges, int(n)))
        buckets.setdefault(bucket_shape(int(n), edges.shape[0]),
                           []).append(i)
    out = []
    for (v_pad, e_pad), members in sorted(buckets.items()):
        stack = np.zeros((len(members), e_pad, 2), np.int32)
        tn = np.zeros(len(members), np.int32)
        te = np.zeros(len(members), np.int32)
        for row, i in enumerate(members):
            edges, n = prepped[i]
            stack[row, : edges.shape[0]] = edges
            tn[row], te[row] = n, edges.shape[0]
        out.append(GraphBatch(edges=stack, num_nodes=v_pad,
                              true_nodes=tn, true_edges=te,
                              indices=np.asarray(members, np.int32)))
    return out


def consistent_rows(pi: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """bool [B]: graph b's edges ([B, E, 2], local ids) all have both
    endpoints under one label of pi [B, V_pad]."""
    return (pi.gather(1, edges[..., 0].long())
            == pi.gather(1, edges[..., 1].long())).all(dim=1)


def bucket_segments(edges: torch.Tensor, true_edges: torch.Tensor,
                    v_pad: int, num_segments: int | None = None):
    """The bucket's segment scan inputs: ``(segments int32 [B, S, seg,
    2], counts int32 [B, S], plan)`` for ``edges`` [B, E_pad, 2] under
    the bucket's one plan, ``plan_segmentation(E_pad, V_pad,
    num_segments)``. Raises ``ValueError`` before allocating if the
    bucket overflows the kernel's int32 ids, in its scan or in a cleanup
    round (one segment of ``plan.padded_edges`` slots)."""
    from repro_torch.kernels.cc_fused.ops import check_batch_extent
    batch, e_pad, _ = edges.shape
    plan = plan_segmentation(e_pad, v_pad, num_segments)
    # padded_edges >= segment_size: the cleanup's segment bounds both
    check_batch_extent(batch, v_pad, plan.padded_edges)
    pad = plan.padded_edges - e_pad
    if pad > 0:
        edges = torch.cat([edges, edges.new_zeros((batch, pad, 2))], dim=1)
    segs = edges.reshape(batch, plan.num_segments, plan.segment_size, 2)
    starts = torch.arange(plan.num_segments, dtype=torch.int32,
                          device=edges.device) * plan.segment_size
    counts = torch.clamp(true_edges[:, None] - starts, 0, plan.segment_size)
    return segs, counts, plan


def solve_bucket(edges: torch.Tensor, true_edges: torch.Tensor,
                 true_nodes: torch.Tensor, v_pad: int, *,
                 num_segments: int | None = None, lift_steps: int = 2,
                 max_rounds: int = rounds.MAX_ROUNDS
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive CC over one bucket: ``edges`` int32 [B, E_pad, 2]
    ((0, 0)-padded, local ids), ``true_edges`` / ``true_nodes`` int32
    [B] billing counts, all on one device. Returns (labels int32 [B,
    V_pad], work int64 [5, B] in ``WorkCounters`` field order).

    One launch of the batched scan for the bucket, then one per cleanup
    round over the graphs still inconsistent (the others get a count of
    0, sit at their fixpoint and are not billed); the [B] consistency
    vector is read back once before the rounds and once per round."""
    from repro_torch.kernels.cc_fused.ops import fused_segment_scan_batched
    batch = edges.shape[0]
    dev = edges.device
    segs, counts, plan = bucket_segments(edges, true_edges, v_pad,
                                         num_segments)
    bill = 1 + lift_steps
    fuel = rounds.compress_fuel(v_pad)
    pi0 = torch.arange(v_pad, dtype=torch.int32, device=dev) \
        .expand(batch, v_pad).contiguous()
    pi, sweeps = fused_segment_scan_batched(pi0, segs, counts,
                                            lift_steps=lift_steps, fuel=fuel)
    total = sweeps.sum(dim=1, dtype=torch.int64)
    hook_ops = counts.sum(dim=1, dtype=torch.int64) * bill
    hook_rounds = torch.full((batch,), plan.num_segments, dtype=torch.int64,
                             device=dev)
    jump_sweeps = total
    jump_ops = total * true_nodes

    flat = segs.reshape(batch, 1, plan.padded_edges, 2)
    active = ~consistent_rows(pi, flat[:, 0])
    for _ in range(max_rounds):
        if not bool(active.any()):
            break
        act = active.to(torch.int64)
        pi, sw = fused_segment_scan_batched(
            pi, flat, (true_edges * active)[:, None], lift_steps=lift_steps,
            fuel=fuel)
        sw = sw[:, 0] * act
        hook_ops = hook_ops + true_edges * bill * act
        hook_rounds = hook_rounds + act
        jump_sweeps = jump_sweeps + sw
        jump_ops = jump_ops + sw * true_nodes
        active = active & ~consistent_rows(pi, flat[:, 0])
    syncs = torch.ones((batch,), dtype=torch.int64, device=dev)
    return pi, torch.stack([hook_ops, jump_ops, jump_sweeps, hook_rounds,
                            syncs])


def solve_batched(graphs: Sequence, *, num_segments: int | None = None,
                  lift_steps: int = 2, device=None) -> list[CCResult]:
    """Adaptive CC over a batch of graphs, one kernel launch per shape
    bucket scan and cleanup round (engine entry of the ``batched``
    backend; callers go through ``repro_torch.api.Solver.solve_batch``).

    Args:
      graphs: ``Graph``s, ``(edges [E, 2], num_nodes)`` pairs or
        ``DeviceGraph``s; sizes may be mixed freely.
      num_segments: override the bucket's 2|E_pad|/|V_pad| heuristic.
      lift_steps: bounded root-chase depth.
      device: where host inputs run (CUDA when None). A fleet of
        ``DeviceGraph``s runs on their one device (``device``, if given,
        must be it).

    Returns:
      One ``CCResult`` per input graph, in input order, labels cut to
      the graph's true |V|; labels and counters equal the reference's
      ``solve_batched``. ``DeviceGraph`` inputs keep their results on
      their device; host inputs get CPU tensors, one copy per bucket.
    """
    graphs = list(graphs)
    device_in = bool(graphs) and all(
        isinstance(g, DeviceGraph) for g in graphs)
    if device_in:
        devs = {g.device for g in graphs}
        if len(devs) != 1:
            raise ValueError(f"a DeviceGraph fleet must live on one "
                             f"device, got {sorted(map(str, devs))}")
        dev = devs.pop()
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != dev.type or (
                want.index is not None and want.index != dev.index)):
            raise ValueError(f"the fleet lives on {dev}, not {device}")
        batches = stack_device_graphs(graphs)
    else:
        dev = resolve_device(device)
        pairs = [(g.edges, g.num_nodes) if hasattr(g, "num_nodes") else g
                 for g in graphs]
        batches = bucketize(pairs)
    results: list[CCResult | None] = [None] * len(graphs)
    for batch in batches:
        edges = batch.edges if device_in \
            else torch.from_numpy(batch.edges).to(dev)
        labels, work = solve_bucket(
            edges, torch.from_numpy(batch.true_edges).to(dev),
            torch.from_numpy(batch.true_nodes).to(dev), batch.num_nodes,
            num_segments=num_segments, lift_steps=lift_steps)
        if not device_in:
            # host views: one copy per bucket, not one per graph
            labels, work = labels.cpu(), work.cpu()
        for row, i in enumerate(batch.indices):
            n = int(batch.true_nodes[row])
            results[int(i)] = CCResult(
                labels=labels[row, :n],
                work=WorkCounters(*(c[row] for c in work)))
    return results  # type: ignore[return-value]
