"""Shared GNN shape set and input-spec builders, the port of
``repro.configs.gnn_common``.

Four shapes:
  full_graph_sm   V=2,708   E=10,556      d_feat=1,433  (cora-scale)
  minibatch_lg    V=232,965 E=114,615,892 seeds=1,024 fanout 15-10
                  d_feat=602 (reddit-scale; the neighbour sampler of
                  ``graphs/sampler.py`` feeds static-shape blocks)
  ogb_products    V=2,449,029 E=61,859,140 d_feat=100
  molecule        128 graphs × 30 nodes × 64 edges (block-diagonal)

Edge lists are symmetrised (both directions), so the static edge count
below is 2E. On ``minibatch_lg`` GraphSAGE takes layered blocks (one a
layer); GIN, GatedGCN and NequIP take the sampled subgraph's edge union
(GraphSAINT-style subgraph sampling).

Specs are ``{name: (shape, torch dtype)}``: what the step takes,
allocated nowhere.
"""
from __future__ import annotations

import torch

SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _pad32(n: int) -> int:
    """Round up to a multiple of 512 (the reference shards node and edge
    dims evenly over a 2×16×16 mesh); padding rows are masked nodes or
    (0, 0) self-loop edges."""
    return ((n + 511) // 512) * 512


# static shapes per cell (logical sizes in comments; padded for sharding)
SHAPE_DEFS = {
    "full_graph_sm": dict(kind="train", v=_pad32(2708),
                          e_sym=_pad32(2 * 10556),
                          d_feat=1433, n_classes=7, graphs=1),
    "minibatch_lg": dict(kind="train", seeds=1024, fanouts=(15, 10),
                         d_feat=602, n_classes=41,
                         # frontier sizes (padded, dedup-free static):
                         n1=1024 * 11, n0=1024 * 11 * 16,
                         e0=1024 * 11 * 15, e1=1024 * 10, graphs=1),
    "ogb_products": dict(kind="train", v=_pad32(2449029),
                         e_sym=_pad32(2 * 61859140),
                         d_feat=100, n_classes=47, graphs=1),
    "molecule": dict(kind="train", graphs=128, nodes_per=30,
                     edges_per=64, d_feat=16, n_classes=2,
                     v=128 * 30, e_sym=2 * 128 * 64),
}


def step_kind(shape: str) -> str:
    return "train"


def feature_gnn_specs(shape: str, layered: bool = False,
                      n_layers: int = 2, d_edge: int = 0,
                      graph_level: bool = False) -> dict:
    """Input specs for feature-based GNNs (SAGE / GIN / GatedGCN)."""
    d = SHAPE_DEFS[shape]
    f32, i32 = torch.float32, torch.int32
    if shape == "minibatch_lg":
        n0 = d["n0"]
        if layered:
            b = {"x": ((n0, d["d_feat"]), f32),
                 "src_0": ((d["e0"],), i32), "dst_0": ((d["e0"],), i32),
                 "src_1": ((d["e1"],), i32), "dst_1": ((d["e1"],), i32),
                 "y": ((n0,), i32), "node_mask": ((n0,), f32)}
        else:
            e_union = d["e0"] + d["e1"]
            b = {"x": ((n0, d["d_feat"]), f32),
                 "src": ((e_union,), i32), "dst": ((e_union,), i32),
                 "y": ((n0,), i32), "node_mask": ((n0,), f32)}
            if d_edge:
                b["edge_attr"] = ((e_union, d_edge), f32)
        return {"batch": b}
    v, e = d["v"], d["e_sym"]
    y_len = d["graphs"] if (shape == "molecule" and graph_level) else v
    b = {"x": ((v, d["d_feat"]), f32),
         "src": ((e,), i32), "dst": ((e,), i32),
         "y": ((y_len,), i32), "node_mask": ((v,), f32)}
    if d_edge:
        b["edge_attr"] = ((e, d_edge), f32)
    if shape == "molecule" and graph_level:
        b["graph_ids"] = ((v,), i32)
    return {"batch": b}


def nequip_specs(shape: str) -> dict:
    """NequIP takes geometry (positions / species); non-molecular graphs
    are point clouds with synthetic coordinates (the compute pattern --
    gather, tensor product, segment sum -- is the same)."""
    d = SHAPE_DEFS[shape]
    f32, i32 = torch.float32, torch.int32
    if shape == "minibatch_lg":
        v, e = d["n0"], d["e0"] + d["e1"]
    else:
        v, e = d["v"], d["e_sym"]
    return {"batch": {
        "positions": ((v, 3), f32), "species": ((v,), i32),
        "src": ((e,), i32), "dst": ((e,), i32),
        "graph_ids": ((v,), i32), "energy": ((d["graphs"],), f32),
    }}
