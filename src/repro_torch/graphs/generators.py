"""Synthetic graph generators.

The paper evaluates on four graph classes (Table I): road maps (usa-osm,
euro-osm — avg degree ~2, huge diameter), social networks
(soc-live-journal — avg degree ~14, power law), and synthetic Kronecker
(kron-logn21 — avg degree ~87, heavy power law). The datasets are not
redistributable here, so the benchmarks run on *scaled stand-ins* matched
on the structural property the adaptive heuristic keys on: the average
degree (plus diameter regime / skew).

A copy of ``repro.graphs.generators``: the same seed gives the same
edges, bit for bit, so both packages solve identical inputs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.format import Graph


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


def grid_road(side: int, extra_prob: float = 0.05, seed: int = 0,
              name: str = "road") -> Graph:
    """2D grid + sparse diagonal shortcuts: road-network stand-in
    (avg degree ≈ 2, O(side) diameter)."""
    rng = _rng(seed)
    ids = np.arange(side * side, dtype=np.int64).reshape(side, side)
    right = np.stack([ids[:, :-1].reshape(-1), ids[:, 1:].reshape(-1)], 1)
    down = np.stack([ids[:-1, :].reshape(-1), ids[1:, :].reshape(-1)], 1)
    edges = np.concatenate([right, down], axis=0)
    # drop a fraction of edges so avg degree lands near the 2.0-2.4 regime
    keep = rng.random(edges.shape[0]) > 0.35
    edges = edges[keep]
    n_extra = int(extra_prob * side * side)
    if n_extra:
        diag = np.stack([ids[:-1, :-1].reshape(-1), ids[1:, 1:].reshape(-1)], 1)
        sel = rng.choice(diag.shape[0], size=min(n_extra, diag.shape[0]),
                         replace=False)
        edges = np.concatenate([edges, diag[sel]], axis=0)
    return Graph(edges=edges, num_nodes=side * side, name=name)


def random_uniform(num_nodes: int, num_edges: int, seed: int = 0,
                   name: str = "uniform") -> Graph:
    rng = _rng(seed)
    edges = rng.integers(0, num_nodes, size=(num_edges, 2), dtype=np.int64)
    return Graph(edges=edges, num_nodes=num_nodes, name=name)


def rmat(scale: int, edge_factor: int, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, name: str = "rmat") -> Graph:
    """R-MAT / Kronecker generator (Graph500 defaults) — power-law
    stand-in for kron-logn21 / soc-live-journal."""
    rng = _rng(seed)
    n = 1 << scale
    e = n * edge_factor
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(e)
        go_right = (r >= a) & (r < ab)          # top-right quadrant
        go_down = (r >= ab) & (r < abc)         # bottom-left
        go_diag = r >= abc                       # bottom-right
        src += ((go_down | go_diag) << bit).astype(np.int64)
        dst += ((go_right | go_diag) << bit).astype(np.int64)
    edges = np.stack([src, dst], axis=1)
    return Graph(edges=edges, num_nodes=n, name=name)


def star(num_nodes: int, center: int = 0) -> Graph:
    others = np.array([i for i in range(num_nodes) if i != center],
                      dtype=np.int64)
    edges = np.stack([np.full_like(others, center), others], axis=1)
    return Graph(edges=edges, num_nodes=num_nodes, name="star")


def chain(num_nodes: int) -> Graph:
    idx = np.arange(num_nodes - 1, dtype=np.int64)
    return Graph(edges=np.stack([idx, idx + 1], 1), num_nodes=num_nodes,
                 name="chain")


def disjoint_cliques(num_cliques: int, clique_size: int,
                     seed: int = 0) -> Graph:
    blocks = []
    for k in range(num_cliques):
        base = k * clique_size
        i, j = np.triu_indices(clique_size, k=1)
        blocks.append(np.stack([i + base, j + base], axis=1))
    edges = np.concatenate(blocks, axis=0)
    return Graph(edges=edges, num_nodes=num_cliques * clique_size,
                 name="cliques")


def molecule_batch(num_graphs: int, nodes_per_graph: int,
                   edges_per_graph: int, d_feat: int = 16,
                   seed: int = 0) -> Graph:
    """Block-diagonal batch of small random molecules (GIN/NequIP shape)."""
    rng = _rng(seed)
    blocks, feats = [], []
    for g in range(num_graphs):
        base = g * nodes_per_graph
        # random connected-ish: a spanning chain + random extras
        idx = np.arange(nodes_per_graph - 1, dtype=np.int64)
        chain_e = np.stack([idx, idx + 1], 1)
        extra = rng.integers(0, nodes_per_graph,
                             size=(max(edges_per_graph - len(chain_e), 0), 2),
                             dtype=np.int64)
        blocks.append(np.concatenate([chain_e, extra], axis=0) + base)
        feats.append(rng.standard_normal((nodes_per_graph, d_feat)))
    return Graph(
        edges=np.concatenate(blocks, axis=0),
        num_nodes=num_graphs * nodes_per_graph,
        node_feat=np.concatenate(feats, axis=0).astype(np.float32),
        name="molecules")


# --------------------------------------------------------------------------
# Table I stand-ins (scaled; matched on avg degree / structure class)
# --------------------------------------------------------------------------

TABLE1_FULL = {
    # name: (nodes, edges, avg_degree, class)
    "usa-osm": (24_000_000, 58_000_000, 2.41, "road"),
    "euro-osm-karls": (174_000_000, 348_000_000, 2.00, "road"),
    "soc-live-journal": (5_000_000, 69_000_000, 14.23, "social"),
    "kron-logn21": (2_000_000, 182_000_000, 86.82, "kron"),
}


def table1_scaled(name: str, scale: float = 1 / 256, seed: int = 0) -> Graph:
    """Scaled stand-in for a Table I graph, same avg-degree regime."""
    if name not in TABLE1_FULL:
        raise KeyError(f"unknown graph {name!r}; have {list(TABLE1_FULL)}")
    nodes, edges, deg, klass = TABLE1_FULL[name]
    if klass == "road":
        side = max(8, int((nodes * scale) ** 0.5))
        return grid_road(side, extra_prob=0.02, seed=seed, name=name)
    if klass == "social":
        sc = max(10, int(np.log2(max(nodes * scale, 2))))
        return rmat(sc, edge_factor=max(2, int(deg / 2)), a=0.45, b=0.22,
                    c=0.22, seed=seed, name=name)
    # kron
    sc = max(10, int(np.log2(max(nodes * scale, 2))))
    return rmat(sc, edge_factor=max(2, int(deg / 2)), seed=seed, name=name)
