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
