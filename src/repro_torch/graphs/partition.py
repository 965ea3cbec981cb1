"""Edge partitioning for distributed CC / GNN (host side), the port of
``repro.graphs.partition``.

The paper's segmentation is temporal (edge segments processed in
sequence on one device). Across devices it becomes spatial: edges are
partitioned over them, each runs CC locally, and the parent arrays are
merged with an elementwise ``min`` (a monotone scatter-min commutes with
it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.format import Graph


def partition_edges(graph: Graph, num_parts: int, mode: str = "block"
                    ) -> np.ndarray:
    """Return edges reshaped to [num_parts, E/num_parts, 2] (padded with
    (0,0) no-op self loops).

    ``block``: contiguous slices (locality-friendly for sorted edge lists).
    ``hash``: by hash of min endpoint (degree-balancing for power-law).
    """
    edges = graph.edges
    e = edges.shape[0]
    per = (e + num_parts - 1) // num_parts
    pad = per * num_parts - e
    if mode == "hash":
        key = (edges.min(axis=1).astype(np.uint32) * np.uint32(2654435761)
               ) % np.uint32(num_parts)
        order = np.argsort(key, kind="stable")
        edges = edges[order]
    elif mode != "block":
        raise ValueError(f"unknown partition mode {mode!r}")
    if pad:
        edges = np.concatenate(
            [edges, np.zeros((pad, 2), dtype=edges.dtype)], axis=0)
    return edges.reshape(num_parts, per, 2)


def boundary_vertices(parts: np.ndarray) -> np.ndarray:
    """Vertices appearing in more than one partition (merge frontier)."""
    seen = {}
    for p in range(parts.shape[0]):
        for v in np.unique(parts[p].reshape(-1)):
            seen.setdefault(int(v), set()).add(p)
    return np.array(sorted(v for v, ps in seen.items() if len(ps) > 1),
                    dtype=np.int32)
