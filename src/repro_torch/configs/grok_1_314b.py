"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

Registered at full width and depth: 316,489,340,928 parameters, 633 GB
in bf16, which one 80 GB card cannot hold. The card runs it at full
width with the depth cut to 6 of 64 layers (31,130,499,072 parameters,
62.3 GB); the smoke config carries the tests. Its prefill attention is
48 query / 8 kv heads of 128, the flash kernel's Hopper body. Training
keeps the optimizer moments in bf16 and accumulates 16 microbatches,
in bf16 too, as the reference's config sets it (``launch.steps``
reads ``MOMENT_DTYPE`` and ``ACCUM_STEPS``)."""
from __future__ import annotations

import torch

from repro_torch.configs import lm_common as LC
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "grok-1-314b"
FAMILY = "lm"
SHAPES = LC.SHAPES

MOMENT_DTYPE = torch.bfloat16   # AdamW moments and gradient accumulator
ACCUM_STEPS = 16                # microbatches a train_4k step


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=32768, vocab=131072,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768,
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
