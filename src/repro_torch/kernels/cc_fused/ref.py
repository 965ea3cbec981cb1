"""Plain PyTorch version of the fused segment-scan kernel: the torch-ops
segment scan, one segment after another, returning the per-segment
sweep counts the kernel returns. The kernel must match it bit for bit —
pi AND sweeps."""
from __future__ import annotations

import torch

from repro_torch.core import rounds


def ref_segment_scan(pi: torch.Tensor, segments: torch.Tensor,
                     true_counts: torch.Tensor, *, lift_steps: int = 2,
                     fuel: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """For each segment i: mask slots >= ``true_counts[i]`` to (0, 0),
    hook from one π snapshot with ``lift_steps`` root-chase levels, then
    Jacobi sweeps to a fixpoint under ``fuel`` (default
    ``compress_fuel(V)``). Returns (π', sweeps int32 [S])."""
    if fuel is None:
        fuel = rounds.compress_fuel(pi.shape[0])
    seg = segments.shape[1]
    slot = torch.arange(seg, device=segments.device)
    sweeps = []
    for edges, cnt in zip(segments, true_counts.tolist()):
        if cnt < seg:
            edges = torch.where((slot < cnt)[:, None], edges, 0)
        pi = rounds.hook_edges(pi, edges, lift_steps=lift_steps)
        pi, n = rounds.jacobi_sweeps(pi, fuel)
        sweeps.append(n)
    return pi, torch.tensor(sweeps, dtype=torch.int32, device=pi.device)


def ref_forest_scan(pi: torch.Tensor, parents: torch.Tensor,
                    parent_eidx: torch.Tensor, edges: torch.Tensor,
                    edge_ids: torch.Tensor, true_counts: torch.Tensor, *,
                    segment_size: int, lift_steps: int, fuel: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """For each segment i (rows ``i * segment_size`` onwards): hook its
    first ``true_counts[i]`` rows with the id-recording forest hook
    (each retired root's winning row and id into ``parents`` and
    ``parent_eidx``, in place), then Jacobi sweeps to a fixpoint under
    ``fuel``. Returns (π', sweeps int32 [S])."""
    sweeps = []
    for i, cnt in enumerate(true_counts.tolist()):
        rows = slice(i * segment_size, i * segment_size + cnt)
        if cnt:
            pi, p, e = rounds.hook_edges_forest_ids(
                pi, parents, parent_eidx, edges[rows], edge_ids[rows],
                lift_steps)
            parents.copy_(p)
            parent_eidx.copy_(e)
        pi, n = rounds.jacobi_sweeps(pi, fuel)
        sweeps.append(n)
    return pi, torch.tensor(sweeps, dtype=torch.int32, device=pi.device)


def ref_segment_scan_batched(pi: torch.Tensor, segments: torch.Tensor,
                             true_counts: torch.Tensor, *,
                             lift_steps: int = 2, fuel: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``ref_segment_scan`` on each graph of a bucket alone: pi [B,
    V_pad] in local ids, segments [B, S, seg, 2], true_counts [B, S];
    ``fuel`` (default ``compress_fuel(V_pad)``) the same for every graph.
    Returns (pi' [B, V_pad], sweeps int32 [B, S])."""
    if fuel is None:
        fuel = rounds.compress_fuel(pi.shape[1])
    out, sweeps = [], []
    for p, segs, counts in zip(pi, segments, true_counts):
        p, sw = ref_segment_scan(p, segs, counts, lift_steps=lift_steps,
                                 fuel=fuel)
        out.append(p)
        sweeps.append(sw)
    if not out:
        return pi.clone(), torch.zeros((0, segments.shape[1]),
                                       dtype=torch.int32, device=pi.device)
    return torch.stack(out), torch.stack(sweeps)
