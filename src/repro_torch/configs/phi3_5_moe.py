"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff_expert=6400 vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Registered at full width and depth: 41,874,100,224 parameters, 83.7 GB
in bf16, more than one 80 GB card holds. The card runs it at full width
with the depth cut to 24 of 32 layers (31,471,636,480 parameters, 62.9
GB); the smoke config carries the tests. Its prefill attention is 32
query / 8 kv heads of 128, the flash kernel's Hopper body."""
from __future__ import annotations

import torch

from repro_torch.configs import lm_common as LC
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"
SHAPES = LC.SHAPES


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=6400, vocab=32064,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                      capacity_factor=1.25),
        dtype=torch.bfloat16, remat=True)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=128,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
        dtype=torch.float32, remat=False)


def step_kind(shape: str) -> str:
    return LC.step_kind(shape)


def skip_reason(shape: str):
    return LC.lm_skip_reason(shape, make_config())


def input_specs(shape: str) -> dict:
    return LC.input_specs(shape, make_config())
