"""Architecture registry: one module per assigned architecture, the
port of ``repro.configs``. The same ten ids: ``dcn-v2`` (recsys), the
five LMs (GQA ``gemma2-2b`` and ``qwen2.5-32b``, MLA ``minicpm3-4b``,
MoE ``grok-1-314b`` and ``phi3.5-moe-42b-a6.6b``) and the four GNNs
(``nequip``, ``gatedgcn``, ``graphsage-reddit``, ``gin-tu``).

A ported module exposes what the launcher consumes:

  ARCH_ID        str
  FAMILY         "lm" | "gnn" | "recsys"
  SHAPES         tuple of shape names (the assigned input-shape set)
  make_config()             full-size model config (GNN:
                            ``make_config(shape)``, the feature width
                            and classes depend on the shape)
  make_smoke_config()       reduced same-family config (CPU tests)
  input_specs(shape)        {name: (shape, torch dtype)} for the step fn
  step_kind(shape)          "train" | "prefill" | "decode" | "serve"
                            | "retrieval"
  skip_reason(shape)        None, or why the cell is skipped
"""
from __future__ import annotations

import importlib

_MODULES = {"qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
            "gemma2-2b": "repro_torch.configs.gemma2_2b",
            "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
            "grok-1-314b": "repro_torch.configs.grok_1_314b",
            "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
            "nequip": "repro_torch.configs.nequip_cfg",
            "gatedgcn": "repro_torch.configs.gatedgcn_cfg",
            "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
            "gin-tu": "repro_torch.configs.gin_tu",
            "dcn-v2": "repro_torch.configs.dcn_v2"}
ARCH_IDS = ("qwen2.5-32b", "gemma2-2b", "minicpm3-4b", "grok-1-314b",
            "phi3.5-moe-42b-a6.6b", "nequip", "gatedgcn",
            "graphsage-reddit", "gin-tu", "dcn-v2")   # the reference's order


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_IDS)}")
    return importlib.import_module(_MODULES[name])


def all_cells():
    """Every (arch, shape, skip reason) triple, in the reference's
    order."""
    cells = []
    for arch_id in ARCH_IDS:
        mod = get_arch(arch_id)
        for shape in mod.SHAPES:
            cells.append((arch_id, shape, mod.skip_reason(shape)))
    return cells
