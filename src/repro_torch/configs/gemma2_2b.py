"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — alternating local(4096-window)+global layers, logit
softcaps, post-norms, embedding scaling. [arXiv:2408.00118; hf]

``long_500k`` runs for this arch: the local half of the stack holds a
bounded 4,096-slot ring cache, global layers are linear per token at
decode.
"""
from __future__ import annotations

import torch

from repro_torch.configs import lm_common as LC
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma2-2b"
FAMILY = "lm"
SHAPES = LC.SHAPES


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab=256000, window=4096,
        layer_pattern="local_global", attn_softcap=50.0,
        final_softcap=30.0, post_norm=True, embed_scale=True,
        tie_embed=True, act="gelu", dtype=torch.bfloat16, remat=True)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=128, window=8,
        layer_pattern="local_global", attn_softcap=50.0,
        final_softcap=30.0, post_norm=True, embed_scale=True,
        act="gelu", dtype=torch.float32, remat=False)


def step_kind(shape: str) -> str:
    return LC.step_kind(shape)


def skip_reason(shape: str):
    return None     # local/global: all four shapes run


def input_specs(shape: str) -> dict:
    return LC.input_specs(shape, make_config())
