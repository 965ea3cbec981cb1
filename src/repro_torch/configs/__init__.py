"""Architecture registry: one module per assigned architecture, the
port of ``repro.configs``. The same ten ids; ``dcn-v2`` (recsys) and
the five LMs (GQA ``gemma2-2b`` and ``qwen2.5-32b``, MLA
``minicpm3-4b``, MoE ``grok-1-314b`` and ``phi3.5-moe-42b-a6.6b``) are
ported so far, and ``get_arch`` raises ``NotImplementedError`` for the
GNN ids, naming the ROADMAP queue that ports them.

A ported module exposes what the launcher consumes:

  ARCH_ID        str
  FAMILY         "lm" | "gnn" | "recsys"
  SHAPES         tuple of shape names (the assigned input-shape set)
  make_config()             full-size model config
  make_smoke_config()       reduced same-family config (CPU tests)
  input_specs(shape)        {name: (shape, torch dtype)} for the step fn
  step_kind(shape)          "train" | "prefill" | "decode" | "serve"
                            | "retrieval"
  skip_reason(shape)        None, or why the cell is skipped
"""
from __future__ import annotations

import importlib

# what each id that is not ported yet waits for
_UNPORTED = {
    "nequip": "gnn",
    "gatedgcn": "gnn",
    "graphsage-reddit": "gnn",
    "gin-tu": "gnn",
}
_QUEUE = {
    "gnn": "ROADMAP A11.4, GNN forward through the segment_reduce kernel",
}
_MODULES = {"qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
            "gemma2-2b": "repro_torch.configs.gemma2_2b",
            "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
            "grok-1-314b": "repro_torch.configs.grok_1_314b",
            "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
            "dcn-v2": "repro_torch.configs.dcn_v2"}
ARCH_IDS = ("qwen2.5-32b", "gemma2-2b", "minicpm3-4b", "grok-1-314b",
            "phi3.5-moe-42b-a6.6b", "nequip", "gatedgcn",
            "graphsage-reddit", "gin-tu", "dcn-v2")   # the reference's order


def get_arch(name: str):
    if name in _UNPORTED:
        kind = _UNPORTED[name]
        raise NotImplementedError(
            f"{name} ({kind}) is not ported yet: {_QUEUE[kind]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_IDS)}")
    return importlib.import_module(_MODULES[name])
