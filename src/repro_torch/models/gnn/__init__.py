"""The GNN family, the port of ``repro.models.gnn``: GraphSAGE
(``graphsage``, with the neighbour sampler's layered blocks), GIN
(``gin``), GatedGCN (``gatedgcn``) and NequIP (``nequip``), over the
shared message passing of ``common`` (segment sums on the
segment-reduce kernel, their gradients on the embedding-bag kernel).

Each model is functions over a params dict whose layout is the
reference's tree (GatedGCN's and NequIP's layers stacked ``[L, ...]``),
so a reference TrainState carries over as a tree map
(``params_from_reference``, ``state_from_reference``) and AdamW's
default ``ndim >= 2`` decay rule reaches the leaves the reference's
does.
"""
from __future__ import annotations

import importlib

_MODELS = {"nequip": "nequip", "gatedgcn": "gatedgcn",
           "graphsage-reddit": "graphsage", "gin-tu": "gin"}


def model_of(arch_id: str):
    """The model module of a GNN arch id."""
    return importlib.import_module(f"repro_torch.models.gnn."
                                   f"{_MODELS[arch_id]}")
