"""Gradient compression, the port of ``repro.train.compression``: int8
uniform quantization with error feedback (EF-SGD, Karimireddy et al.).

Each worker quantizes (grad + residual), would all-reduce the int8
payload, dequantizes, and keeps the quantization error as next step's
residual.

``compress`` / ``decompress`` / ``zero_residual`` are the transform pair
over name-keyed dicts of tensors (any tree that ``optimizer.named``
takes). The reference's ``compressed_psum``, the same transform around a
``psum`` inside ``shard_map``, waits for the multi-GPU NCCL item
(ROADMAP queue A, item 3): one card has no collective to put it around.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import named


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp -> int8 with round-to-nearest-even; scale maps max|x| -> 127."""
    q = torch.round(x.float() / torch.clamp(scale, min=1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def compress(grads, residual):
    """(grads + residual) -> (int8 payload, scales, new_residual)."""
    residual = named(residual)
    payload, scales, new_res = {}, {}, {}
    for n, g in named(grads).items():
        gf = g.float() + residual[n]
        scale = torch.max(torch.abs(gf)) / 127.0
        q = _quantize(gf, scale)
        payload[n], scales[n] = q, scale
        new_res[n] = gf - q.float() * scale    # error feedback residual
    return payload, scales, new_res


def decompress(payload, scales, dtype_tree):
    dtypes = named(dtype_tree)
    return {n: (q.float() * scales[n]).to(dtypes[n].dtype)
            for n, q in named(payload).items()}


def zero_residual(params):
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}
