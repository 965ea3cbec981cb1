"""gin-tu [gnn]: 5 layers, d_hidden=64, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]

Graph-level readout on ``molecule``; node-level on the other shapes.
``minibatch_lg`` takes the sampled subgraph's edge union (5 layers > 2
sampled block levels, GraphSAINT-style).
"""
from __future__ import annotations

from repro_torch.configs import gnn_common as GC
from repro_torch.models.gnn.gin import GINConfig

ARCH_ID = "gin-tu"
FAMILY = "gnn"
SHAPES = GC.SHAPES


def make_config(shape: str = "molecule") -> GINConfig:
    d = GC.SHAPE_DEFS[shape]
    return GINConfig(name=ARCH_ID, n_layers=5,
                     d_in=d["d_feat"], d_hidden=64,
                     n_classes=d["n_classes"],
                     graph_level=(shape == "molecule"),
                     num_graphs=d["graphs"])


def make_smoke_config() -> GINConfig:
    return GINConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=16,
                     d_hidden=32, n_classes=2, graph_level=True,
                     num_graphs=8)


def step_kind(shape: str) -> str:
    return GC.step_kind(shape)


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    return GC.feature_gnn_specs(shape, layered=False,
                                graph_level=(shape == "molecule"))
