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


class DynamicConnectivityOracle:
    """Host ground truth for interleaved insert / delete scripts: a
    multiset edge log with the deletion semantics of
    ``repro_torch.core.incremental.DynamicCC`` (a delete of undirected
    edge {u, v} is orientation-blind and retires every surviving copy;
    deleting an absent edge is a no-op).

    The reference keeps a Python list of tuples. Here the log is a numpy
    array in insertion order with an alive mask, and each inserted chunk
    keeps its rows sorted by undirected key, so a delete finds its rows
    by binary search: ``alive()`` returns the reference's rows in the
    reference's order, at tens of millions of edges."""

    def __init__(self, num_nodes: int):
        self.num_nodes = int(num_nodes)
        self._edges = np.zeros((0, 2), np.int64)
        self._alive = np.zeros((0,), bool)
        self._rows = 0
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []

    @staticmethod
    def _keys(edges: np.ndarray) -> np.ndarray:
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        return (lo << 32) | hi

    def insert(self, edges) -> None:
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        n, r = edges.shape[0], self._rows
        if r + n > self._edges.shape[0]:
            cap = max(2 * self._edges.shape[0], r + n, 64)
            grown = np.zeros((cap, 2), np.int64)
            grown[:r] = self._edges[:r]
            alive = np.zeros((cap,), bool)
            alive[:r] = self._alive[:r]
            self._edges, self._alive = grown, alive
        self._edges[r:r + n] = edges
        self._alive[r:r + n] = True
        self._rows += n
        order = np.argsort(self._keys(edges))
        self._chunks.append((self._keys(edges)[order], order + r))

    def delete(self, edges) -> None:
        kill = np.unique(self._keys(np.asarray(edges, np.int64)
                                    .reshape(-1, 2)))
        for keys, rows in self._chunks:
            lo = np.searchsorted(keys, kill, side="left")
            hi = np.searchsorted(keys, kill, side="right")
            lens = hi - lo
            if lens.any():
                # positions lo[i] .. hi[i] - 1 of every key, flattened
                first = np.cumsum(lens) - lens
                pos = np.arange(int(lens.sum())) + np.repeat(lo - first,
                                                             lens)
                self._alive[rows[pos]] = False

    def alive(self) -> np.ndarray:
        """The surviving rows, int64 [N, 2], in insertion order."""
        r = self._rows
        return self._edges[:r][self._alive[:r]]

    def labels(self) -> np.ndarray:
        want = connected_components_oracle(self.alive(), self.num_nodes)
        cross = connected_components_scipy(self.alive(), self.num_nodes)
        if cross is not None and not np.array_equal(want, cross):
            raise AssertionError(       # pragma: no cover - oracle bug
                "union-find and scipy oracles disagree")
        return want
