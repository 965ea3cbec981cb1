"""graphsage-reddit [gnn]: 2 layers, d_hidden=128, mean aggregator,
sample_sizes=25-10. [arXiv:1706.02216; paper]

``minibatch_lg`` takes layered sampled blocks (the neighbour sampler in
``graphs/sampler.py``); full-graph shapes take dense edge lists."""
from __future__ import annotations

from repro_torch.configs import gnn_common as GC
from repro_torch.models.gnn.graphsage import SAGEConfig

ARCH_ID = "graphsage-reddit"
FAMILY = "gnn"
SHAPES = GC.SHAPES


def make_config(shape: str = "minibatch_lg") -> SAGEConfig:
    d = GC.SHAPE_DEFS[shape]
    return SAGEConfig(name=ARCH_ID, n_layers=2, d_in=d["d_feat"],
                      d_hidden=128, n_classes=d["n_classes"])


def make_smoke_config() -> SAGEConfig:
    return SAGEConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=16,
                      d_hidden=32, n_classes=5)


def step_kind(shape: str) -> str:
    return GC.step_kind(shape)


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    return GC.feature_gnn_specs(shape, layered=(shape == "minibatch_lg"),
                                n_layers=2)
