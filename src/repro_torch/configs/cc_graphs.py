"""Table I graph specs (the paper's own evaluation set) for the
``cc-adaptive`` cell, the port of ``repro.configs.cc_graphs``: the four
full-size graphs as edge-list specs the multi-shard engine takes
(``launch.steps.build_cell("cc-adaptive", shape)``), and the scaled
stand-ins for runs at smaller size."""
from __future__ import annotations

import torch

from repro_torch.graphs.generators import TABLE1_FULL, table1_scaled  # noqa: F401

ARCH_ID = "cc-adaptive"
FAMILY = "cc"
SHAPES = tuple(TABLE1_FULL)      # usa-osm, euro-osm-karls, soc-lj, kron


def step_kind(shape: str) -> str:
    return "cc"


def skip_reason(shape: str):
    return None


def input_specs(shape: str) -> dict:
    nodes, edges, _, _ = TABLE1_FULL[shape]
    return {"edges": ((edges, 2), torch.int32), "num_nodes": nodes}
