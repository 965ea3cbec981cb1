"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]

Registered at full width; its 65 GB of bf16 weights are not run on one
80 GB card (the smoke config carries the tests)."""
from __future__ import annotations

import torch

from repro_torch.configs import lm_common as LC
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2.5-32b"
FAMILY = "lm"
SHAPES = LC.SHAPES
ACCUM_STEPS = 16                # microbatches a train_4k step


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=27648, vocab=152064, qkv_bias=True,
        rope_theta=1_000_000.0, dtype=torch.bfloat16, remat=True)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab=128, qkv_bias=True,
        dtype=torch.float32, remat=False)


def step_kind(shape: str) -> str:
    return LC.step_kind(shape)


def skip_reason(shape: str):
    return LC.lm_skip_reason(shape, make_config())


def input_specs(shape: str) -> dict:
    return LC.input_specs(shape, make_config())
