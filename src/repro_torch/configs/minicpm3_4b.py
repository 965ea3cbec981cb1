"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, q_lora=768, kv_lora=256, decoupled RoPE).
[hf:openbmb/MiniCPM3-4B; hf]

The card runs it at full width and full depth: 4,262,025,728
parameters, 8.52 GB in bf16. Its prefill attention has q / k head dim
96 and v head dim 64, which the flash kernel takes zero-padded to 128
(``layers.multi_head_attention``), 40 query heads over 40 kv heads."""
from __future__ import annotations

import torch

from repro_torch.configs import lm_common as LC
from repro_torch.models.transformer import LMConfig, MLAConfig

ARCH_ID = "minicpm3-4b"
FAMILY = "lm"
SHAPES = LC.SHAPES


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        head_dim=64, d_ff=6400, vocab=73448, attention="mla",
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                      qk_rope_dim=32, v_head_dim=64),
        dtype=torch.bfloat16, remat=True)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab=128, attention="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        dtype=torch.float32, remat=False)


def step_kind(shape: str) -> str:
    return LC.step_kind(shape)


def skip_reason(shape: str):
    return LC.lm_skip_reason(shape, make_config())


def input_specs(shape: str) -> dict:
    return LC.input_specs(shape, make_config())
