"""Label-propagation CC baseline (paper §I — the other classic parallel
approach). Included because the paper positions Hook-Compress against it:
label propagation needs O(diameter) sweeps, which is why it loses badly on
high-diameter (road) graphs."""
from __future__ import annotations

import torch

from repro_torch.core.cc import CCResult, WorkCounters

_MAX_ITERS = 4096


def _cc_labelprop(edges: torch.Tensor, num_nodes: int,
                  true_edges=None) -> CCResult:
    u, v = edges[:, 0], edges[:, 1]
    e = edges.shape[0] if true_edges is None else true_edges
    lab = torch.arange(num_nodes, dtype=torch.int32, device=edges.device)
    work = WorkCounters.zeros(edges.device)
    changed, iters = True, 0
    while changed and iters < _MAX_ITERS:
        # disseminate min label across every edge, both directions
        new = lab.scatter_reduce(0, v.long(), lab[u], reduce="amin")
        new = new.scatter_reduce(0, u.long(), new[v], reduce="amin")
        changed = bool((new != lab).any())
        work = work.add(hook_ops=2 * e, hook_rounds=1, sync_rounds=1)
        lab, iters = new, iters + 1
    return CCResult(lab, work)
