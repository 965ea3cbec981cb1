"""Plain PyTorch versions of the hook kernel."""
from __future__ import annotations

import torch

from repro_torch.core.rounds import hook_edges


def ref_hook_round(pi: torch.Tensor, edges: torch.Tensor,
                   lift_steps: int = 0) -> torch.Tensor:
    """One functional hook round (all edges see the same π snapshot)."""
    return hook_edges(pi, edges, lift_steps=lift_steps)


def ref_hook_tiled(pi: torch.Tensor, edges: torch.Tensor, edge_tile: int,
                   lift_steps: int = 0) -> torch.Tensor:
    """The kernel's *sequential-tile* semantics: tile t observes the
    hooks of tiles < t; inside a tile, one snapshot."""
    for start in range(0, edges.shape[0], edge_tile):
        pi = ref_hook_round(pi, edges[start:start + edge_tile], lift_steps)
    return pi
