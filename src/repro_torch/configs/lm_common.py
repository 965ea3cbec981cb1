"""The LM shape set and its input specs, the port of
``repro.configs.lm_common``.

LM shapes are seq_len x global batch. ``decode_*`` / ``long_*`` are one
new token against a KV cache of seq_len (the serving decode step);
``prefill_*`` is the prompt pass; ``train_*`` the training step
(``batch["tokens"]`` [B, S + 1] int32: S inputs and their next
tokens). Specs are trees of ``(shape, torch dtype)``; building one
allocates nothing.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def step_kind(shape: str) -> str:
    return SHAPE_DEFS[shape]["kind"]


def lm_skip_reason(shape: str, cfg: T.LMConfig) -> str | None:
    if shape == "long_500k" and cfg.window == 0:
        return ("pure full-attention arch: 524k decode needs "
                "sub-quadratic attention state (see DESIGN.md "
                "§Arch-applicability)")
    return None


def input_specs(shape: str, cfg: T.LMConfig) -> dict:
    d = SHAPE_DEFS[shape]
    s, b = d["seq"], d["batch"]
    i32 = torch.int32
    if d["kind"] == "train":
        return {"batch": {"tokens": ((b, s + 1), i32)}}
    if d["kind"] == "prefill":
        return {"tokens": ((b, s), i32), "cache": T.cache_spec(cfg, b, s)}
    # decode: one token against a cache of `seq` positions
    return {"tokens": ((b,), i32), "positions": ((b,), i32),
            "cache": T.cache_spec(cfg, b, s)}
