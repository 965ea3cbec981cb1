"""R-MAT / Kronecker graph (Graph500's quadrant probabilities), made on
the device from a seed.

``2**scale`` vertices and ``edge_factor * 2**scale`` edges; each edge
picks one quadrant per bit with probabilities a, b, c and 1 - a - b - c,
as the program's own ``rmat`` generator does, with no vertex
relabelling (vertex 0 is the largest hub), duplicates and self loops
kept. One ``torch.rand`` of E floats per bit, on the device.

With ``distinct`` the graph is made simple, as the published DIMACS
files are: self loops dropped, each undirected edge kept once as a
(min, max) row, the rows put in an order drawn from the seed, and the
first ``num_edges`` of them kept, so that every seed gives the same
number of edges.
"""
from __future__ import annotations

import torch


def generate(params: dict, gen: torch.Generator, device
             ) -> tuple[torch.Tensor, int]:
    """``(edges, num_nodes)``: int32 [E, 2] on ``device``."""
    scale = int(params["scale"])
    n = 1 << scale
    e = n * int(params["edge_factor"])
    a, b, c = (float(params[k]) for k in ("a", "b", "c"))
    ab, abc = a + b, a + b + c
    edges = torch.zeros((e, 2), dtype=torch.int32, device=device)
    for bit in range(scale):
        r = torch.rand(e, generator=gen, device=device)
        right = (r >= a) & (r < ab)
        down = (r >= ab) & (r < abc)
        diag = r >= abc
        del r
        edges[:, 0] |= (down | diag).to(torch.int32) << bit
        edges[:, 1] |= (right | diag).to(torch.int32) << bit
    if not params.get("distinct"):
        return edges, n
    lo = torch.minimum(edges[:, 0], edges[:, 1]).long()
    hi = torch.maximum(edges[:, 0], edges[:, 1]).long()
    del edges
    keys = torch.unique(((lo << scale) | hi)[lo != hi])
    del lo, hi
    keep = int(params.get("num_edges", keys.shape[0]))
    if keep > keys.shape[0]:
        raise ValueError(f"{keys.shape[0]} distinct edges, fewer than the "
                         f"{keep} asked for: raise edge_factor")
    keys = keys[torch.randperm(keys.shape[0], generator=gen,
                               device=device)[:keep]]
    return torch.stack([keys >> scale, keys & (n - 1)], 1).to(torch.int32), n
