"""Road-network stand-in, made on the device from a seed.

A ``side`` x ``side`` grid whose right and down edges are thinned to
``1 - drop_prob`` of them, plus ``extra_prob * side**2`` diagonal
shortcuts drawn without replacement: the shape of the program's own
``grid_road`` generator (average degree about 2.6, a diameter of order
``side``), made by ``torch`` on the device in a few large calls. The
kept grid edges are an exact count chosen by a random permutation (the
host generator draws a Bernoulli mask), so every seed gives the same
number of edges; they stay in grid order, as the host generator leaves
them, and the shortcuts follow in their random order.
"""
from __future__ import annotations

import torch


def generate(params: dict, gen: torch.Generator, device
             ) -> tuple[torch.Tensor, int]:
    """``(edges, num_nodes)``: int32 [E, 2] on ``device``."""
    side = int(params["side"])
    n = side * side
    ids = torch.arange(n, dtype=torch.int32, device=device).view(side, side)
    grid = torch.cat([
        torch.stack([ids[:, :-1].reshape(-1), ids[:, 1:].reshape(-1)], 1),
        torch.stack([ids[:-1, :].reshape(-1), ids[1:, :].reshape(-1)], 1)])
    keep = round((1.0 - float(params["drop_prob"])) * grid.shape[0])
    sel = torch.randperm(grid.shape[0], generator=gen,
                         device=device)[:keep].sort().values
    kept = grid[sel]
    del grid, sel
    n_extra = min(int(float(params["extra_prob"]) * n), (side - 1) ** 2)
    diag = torch.stack([ids[:-1, :-1].reshape(-1),
                        ids[1:, 1:].reshape(-1)], 1)
    pick = torch.randperm(diag.shape[0], generator=gen,
                          device=device)[:n_extra]
    return torch.cat([kept, diag[pick]]).contiguous(), n
