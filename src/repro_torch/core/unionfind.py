"""Host-side union-find oracle for connected components.

Pure numpy (scipy lazily): a copy of the oracles of
``repro.core.unionfind``, used only as ground truth in tests and in
``chip_smoke.py``. Labels follow the package's canonical convention:
every vertex is labeled with the *minimum* vertex id of its component.
"""
from __future__ import annotations

import numpy as np


class UnionFind:
    """Classic union-find with path compression + union by size."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        # path compression
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return int(root)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def connected_components_oracle(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Min-vertex-id component labels via union-find.

    Args:
      edges: int array [E, 2]; self loops / duplicates / empty allowed.
      num_nodes: number of vertices.

    Returns:
      int32 [num_nodes] labels; labels[v] == min vertex id in v's component.
    """
    uf = UnionFind(num_nodes)
    edges = np.asarray(edges).reshape(-1, 2)
    for u, v in edges:
        if 0 <= u < num_nodes and 0 <= v < num_nodes:
            uf.union(int(u), int(v))
    roots = np.array([uf.find(i) for i in range(num_nodes)], dtype=np.int64)
    # canonicalize: label = min vertex id in component
    min_label = np.full(num_nodes, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(min_label, roots, np.arange(num_nodes, dtype=np.int64))
    return min_label[roots].astype(np.int32)


def num_components(labels: np.ndarray) -> int:
    return int(np.unique(np.asarray(labels)).size)


def connected_components_scipy(edges: np.ndarray, num_nodes: int
                               ) -> np.ndarray | None:
    """Independent second oracle via ``scipy.sparse.csgraph``,
    canonicalized to the same min-vertex-id convention; returns None
    when scipy is absent (the union-find oracle stands alone then).
    Two disagreeing oracles would flag an oracle bug rather than an
    engine bug — the conformance suite cross-checks them."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components as cc
    except ImportError:                                # pragma: no cover
        return None
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    ok = ((edges >= 0) & (edges < num_nodes)).all(axis=1) \
        if edges.size else np.zeros((0,), bool)
    edges = edges[ok]
    mat = sp.coo_matrix(
        (np.ones(edges.shape[0]), (edges[:, 0], edges[:, 1])),
        shape=(num_nodes, num_nodes))
    _, comp = cc(mat, directed=False)
    min_label = np.full(num_nodes, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(min_label, comp, np.arange(num_nodes, dtype=np.int64))
    return min_label[comp].astype(np.int32)
