"""gatedgcn [gnn]: 16 layers, d_hidden=70, gated aggregator.
[arXiv:2003.00982; paper]"""
from __future__ import annotations

from repro_torch.configs import gnn_common as GC
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
SHAPES = GC.SHAPES

D_EDGE = 8      # edge-feature width (benchmarking-gnns convention)


def make_config(shape: str = "full_graph_sm") -> GatedGCNConfig:
    d = GC.SHAPE_DEFS[shape]
    return GatedGCNConfig(name=ARCH_ID, n_layers=16,
                          d_in=d["d_feat"], d_edge_in=D_EDGE,
                          d_hidden=70, n_classes=d["n_classes"])


def make_smoke_config() -> GatedGCNConfig:
    return GatedGCNConfig(name=ARCH_ID + "-smoke", n_layers=3, d_in=16,
                          d_edge_in=8, d_hidden=32, n_classes=4)


def step_kind(shape: str) -> str:
    return GC.step_kind(shape)


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    return GC.feature_gnn_specs(shape, layered=False, d_edge=D_EDGE)
