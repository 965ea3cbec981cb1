"""Graph containers and host-side format conversion (COO <-> CSR).

Pure numpy: a copy of ``repro.graphs.format``. ``Graph`` is the host
COO graph the generators return; CSR here is a host-side structure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray   # int64 [V+1]
    indices: np.ndarray  # int32 [E]

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def build_csr(edges: np.ndarray, num_nodes: int,
              symmetrize: bool = True) -> CSR:
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    src, dst = edges[:, 0], edges[:, 1]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=indptr, indices=dst.astype(np.int32))


@dataclasses.dataclass
class Graph:
    """COO graph. ``edges`` stores each undirected edge once."""

    edges: np.ndarray                      # int32 [E, 2]
    num_nodes: int
    node_feat: Optional[np.ndarray] = None  # [V, d] float32
    edge_feat: Optional[np.ndarray] = None  # [E, d_e] float32
    labels: Optional[np.ndarray] = None      # [V] int32 (targets)
    name: str = "graph"

    def __post_init__(self):
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def avg_degree(self) -> float:
        return 2.0 * self.num_edges / max(self.num_nodes, 1)

    def degrees(self) -> np.ndarray:
        deg = np.bincount(self.edges.reshape(-1).astype(np.int64),
                          minlength=self.num_nodes)
        return deg

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    def to_csr(self, symmetrize: bool = True) -> CSR:
        return build_csr(self.edges, self.num_nodes, symmetrize=symmetrize)

    def symmetrized_edges(self) -> np.ndarray:
        """Both directions of every edge — the GNN message-passing view."""
        return np.concatenate([self.edges, self.edges[:, ::-1]], axis=0)

    def pad_edges(self, multiple: int) -> "Graph":
        """Pad the edge list with (0, 0) self loops to a static multiple
        (self loops are hook/message no-ops)."""
        e = self.num_edges
        target = ((e + multiple - 1) // multiple) * multiple
        if target == e:
            return self
        pad = np.zeros((target - e, 2), dtype=np.int32)
        return dataclasses.replace(
            self, edges=np.concatenate([self.edges, pad], axis=0))

    def permute_nodes(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices by ``perm`` (tests: CC must be equivariant)."""
        perm = np.asarray(perm, dtype=np.int32)
        new = dataclasses.replace(self, edges=perm[self.edges])
        if self.node_feat is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size, dtype=np.int32)
            new.node_feat = self.node_feat[inv]
        return new

    def stats(self) -> dict:
        deg = self.degrees()
        return {
            "name": self.name,
            "nodes": self.num_nodes,
            "edges": self.num_edges,
            "avg_degree": round(self.avg_degree, 2),
            "max_degree": int(deg.max(initial=0)),
            "size_mb": round(self.edges.nbytes / 2**20, 2),
        }
