"""Sampling-accelerated CC: the k-out (Afforest-style) engine of
``repro.core.sampled``, on torch tensors.

On skewed-degree graphs a cheap neighbour-sampling phase collapses the
giant component before the full edge list is touched, so the full scan
only has to cover the small residue. Two phases:

* the sample phase builds CSR offsets on the device (a stable sort and
  ``searchsorted`` over the symmetrized edge list, so edges stored in
  one direction still sample both endpoints), takes the first ``k``
  slots of each vertex (invalid slots become (0, 0) no-ops and are never
  billed), and runs ``sample_rounds`` hook + compress rounds over the
  |V| * k sampled edges, recording the spanning forest as it hooks. A
  census names the giant component, for telemetry only;
* the residue scan takes every stored edge whose endpoints still carry
  different labels, packs those rows into a (0, 0)-padded prefix (one
  stable sort; row order decides which edge lands in which segment) and
  runs the Fig. 4 segment scan and cleanup over them from the sampled
  labels, billing the residue count only. ``fused=True`` runs it with
  the fused segment-scan kernel's ops (``sampled_fused``), which record
  no forest; otherwise with recording torch ops.

Work: the sample phase bills valid slots x (1 + lift_steps) hook
evaluations per round; the residue scan bills true residue edges.
WorkCounters, ``parents`` and every ``stats`` entry equal the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.connectivity.queries import component_census
from repro_torch.core import rounds
from repro_torch.core.rounds import WorkCounters
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import as_device_graph
from repro_torch.obs import trace as obs

SAMPLE_K = 2          # neighbours sampled per vertex (Afforest's k)
SAMPLE_ROUNDS = 2     # fixed hook + compress rounds over the sample


class SampledResult(NamedTuple):
    """Labels, forest and work, plus the phase-split telemetry."""

    labels: torch.Tensor          # int32 [V] canonical min-id labels
    parents: torch.Tensor         # int32 [V, 2] forest edges (-1 = root)
    work: WorkCounters            # sample + residue billing
    stats: dict                   # 0-d tensors: phase split (int64
                                  # hook_ops, as work) + giant (int32)


def _sample_phase(edges: torch.Tensor, true_edges: int, num_nodes: int,
                  k: int, sample_rounds: int, lift_steps: int):
    """k-out sampling phase. Returns ``(pi, parents, work, n_sampled,
    giant_label, giant_size)``, the last three 0-d int32 tensors.

    The CSR slots are int32, as in the reference: they index the
    symmetrized list of 2|E| rows, and 2|E| of the largest stand-in
    (kron-logn21 at scale 1.0: 90,177,536) is far below 2^31."""
    dev = edges.device
    e = edges.shape[0]
    sym = torch.cat([edges, edges.flip(1)])
    row_real = torch.arange(e, dtype=torch.int32, device=dev) < true_edges
    real = torch.cat([row_real, row_real])
    src = sym[:, 0].contiguous()
    order = torch.argsort(src, stable=True)
    sorted_src = src[order]
    neighbors = sym[order, 1]
    real_sorted = real[order]
    offsets = torch.searchsorted(
        sorted_src, torch.arange(num_nodes + 1, dtype=torch.int32,
                                 device=dev), out_int32=True)
    # slot (v, j) = CSR position offsets[v] + j; valid iff inside v's row
    # and backed by a true (unpadded) edge
    slots = offsets[:-1, None] + torch.arange(k, dtype=torch.int32,
                                              device=dev)[None, :]
    in_row = slots < offsets[1:, None]
    slots_c = torch.clamp(slots, max=2 * e - 1).long()
    valid = in_row & real_sorted[slots_c]
    ids = torch.arange(num_nodes, dtype=torch.int32, device=dev)[:, None]
    su = torch.where(valid, ids, 0)
    sv = torch.where(valid, neighbors[slots_c], 0)
    sampled = torch.stack([su.reshape(-1), sv.reshape(-1)], dim=-1)
    n_sampled = valid.sum(dtype=torch.int32)

    pi = torch.arange(num_nodes, dtype=torch.int32, device=dev)
    ops = rounds.forest_round_ops(rounds.empty_forest(num_nodes, dev),
                                  lift_steps=lift_steps)
    work = WorkCounters.zeros(dev)
    bill = n_sampled * (1 + lift_steps)
    for _ in range(sample_rounds):
        pi = ops.hook(pi, sampled)
        work = work.add(hook_ops=bill, hook_rounds=1)
        pi, work = rounds.compress(pi, work)
    (parents,) = ops.tables()

    census = component_census(pi)
    giant = torch.argmax(census).to(torch.int32)    # ties: first index
    return pi, parents, work, n_sampled, giant, census[giant.long()]


def _residue_scan(edges: torch.Tensor, true_edges: int, pi: torch.Tensor,
                  parents: torch.Tensor, work: WorkCounters, *,
                  num_nodes: int, num_segments: int, lift_steps: int,
                  fused: bool):
    """Adaptive Fig. 4 scan over the residue only, from the sampled
    labels. Returns ``(pi, parents, work, n_residue)``."""
    dev = edges.device
    e = edges.shape[0]
    row_real = torch.arange(e, dtype=torch.int32, device=dev) < true_edges
    live = (pi[edges[:, 0]] != pi[edges[:, 1]]) & row_real
    n_res = live.sum(dtype=torch.int32)
    # residue rows first, each side in row order (a stable sort of the
    # boolean as an integer: the order decides segments, so parents and
    # jump_sweeps)
    order = torch.argsort((~live).to(torch.uint8), stable=True)
    packed = torch.where(live[order][:, None], edges[order], 0)
    plan = plan_segmentation(e, num_nodes, num_segments)
    n = int(n_res)
    ops = rounds.fused_round_ops(lift_steps) if fused \
        else rounds.forest_round_ops(parents, lift_steps=lift_steps)
    pi, work = rounds.segment_scan(
        pi, packed, ops, work,
        rounds.segment_true_counts(n, plan, device=dev),
        segment_size=plan.segment_size)
    pi, work = rounds.cleanup_rounds(pi, packed, ops, work, true_edges=n)
    if ops.tables is not None:
        (parents,) = ops.tables()
    return pi, parents, work, n_res


def _stats(dev, giant_size: int) -> dict:
    z = torch.zeros((), dtype=torch.int32, device=dev)
    w = WorkCounters.zeros(dev).hook_ops
    return {"sample_hook_ops": w, "residue_hook_ops": w, "n_sampled": z,
            "n_residue": z, "giant_label": z,
            "giant_size": torch.full((), giant_size, dtype=torch.int32,
                                     device=dev)}


def solve_sampled(graph, num_nodes: int | None = None, *,
                  k: int = SAMPLE_K, sample_rounds: int = SAMPLE_ROUNDS,
                  num_segments: int | None = None, lift_steps: int = 2,
                  fused: bool = False, device=None) -> SampledResult:
    """The sampled engine entry (backends ``sampled`` and
    ``sampled_fused``).

    The k-out sampling phase, then the adaptive scan over the residue;
    ``fused=True`` runs the residue scan on the fused segment-scan
    kernel, which records no forest on the residue. Each phase runs under
    its own ``repro_torch.obs`` span, and the sample-vs-residue work
    split lands in ``stats``."""
    g = as_device_graph(graph, num_nodes, num_segments=num_segments,
                        device=device)
    v, dev = g.num_nodes, g.device
    if v <= 0:
        return SampledResult(torch.zeros((0,), dtype=torch.int32, device=dev),
                             rounds.empty_forest(0, dev),
                             WorkCounters.zeros(dev), _stats(dev, 0))
    if g.is_empty:
        return SampledResult(torch.arange(v, dtype=torch.int32, device=dev),
                             rounds.empty_forest(v, dev),
                             WorkCounters.zeros(dev), _stats(dev, 1))
    with obs.span("sampled.sample_phase", num_nodes=v, k=k):
        pi, parents, s_work, n_sampled, giant, giant_size = _sample_phase(
            g.edges, g.true_edges, v, k, sample_rounds, lift_steps)
    with obs.span("sampled.residue_scan", num_nodes=v):
        pi, parents, work, n_res = _residue_scan(
            g.edges, g.true_edges, pi, parents, s_work, num_nodes=v,
            num_segments=g.plan.num_segments, lift_steps=lift_steps,
            fused=fused)
    work = work.add(sync_rounds=2)      # one device program per phase
    stats = {"sample_hook_ops": s_work.hook_ops,
             "residue_hook_ops": work.hook_ops - s_work.hook_ops,
             "n_sampled": n_sampled, "n_residue": n_res,
             "giant_label": giant, "giant_size": giant_size}
    # always-on host counters: the sample-vs-residue work split is
    # counted whether or not span tracing is enabled
    obs.count("sampled.solves")
    obs.count("sampled.hook_ops.sample", int(stats["sample_hook_ops"]))
    obs.count("sampled.hook_ops.residue", int(stats["residue_hook_ops"]))
    return SampledResult(pi, parents, work, stats)
