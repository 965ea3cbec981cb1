"""Architecture registry: one module per assigned architecture, the
port of ``repro.configs``. The same ten ids; only ``dcn-v2`` (the
recsys family) is ported so far, and ``get_arch`` raises
``NotImplementedError`` for the others, naming the ROADMAP queue that
ports them.

A ported module exposes what the launcher consumes:

  ARCH_ID        str
  FAMILY         "lm" | "gnn" | "recsys"
  SHAPES         tuple of shape names (the assigned input-shape set)
  make_config()             full-size model config
  make_smoke_config()       reduced same-family config (CPU tests)
  input_specs(shape)        {name: (shape, torch dtype)} for the step fn
  step_kind(shape)          "train" | "serve" | "retrieval" | ...
  skip_reason(shape)        None, or why the cell is skipped
"""
from __future__ import annotations

import importlib

# the family of each id that is not ported yet
_UNPORTED = {
    "qwen2.5-32b": "lm",
    "gemma2-2b": "lm",
    "minicpm3-4b": "lm",
    "grok-1-314b": "lm",
    "phi3.5-moe-42b-a6.6b": "lm",
    "nequip": "gnn",
    "gatedgcn": "gnn",
    "graphsage-reddit": "gnn",
    "gin-tu": "gnn",
}
_QUEUE = {
    "lm": "ROADMAP A11, the LM serving slice (with the flash_attention "
          "kernel)",
    "gnn": "ROADMAP A11, GNN forward through the segment_reduce kernel",
}
_MODULES = {"dcn-v2": "repro_torch.configs.dcn_v2"}

ARCH_IDS = (*_UNPORTED, *_MODULES)          # the reference's order


def get_arch(name: str):
    if name in _UNPORTED:
        family = _UNPORTED[name]
        raise NotImplementedError(
            f"{name} ({family}) is not ported yet: {_QUEUE[family]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_IDS)}")
    return importlib.import_module(_MODULES[name])
