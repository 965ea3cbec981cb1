"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Kernel, check_tensor, stream_of
from repro_torch.kernels.flash_attention.ref import ref_flash_attention

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
KERNEL = Kernel("flash_attention", "flash_attention",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention over positions 0.. of both sequences.

    q [B, Sq, Hq, d]; k, v [B, Sk, Hkv, d] with Hq % Hkv == 0, all of
    one dtype (float32 or bfloat16); returns [B, Sq, Hq, d] in q's
    dtype. ``causal`` keeps keys j <= i, ``window`` > 0 keeps
    i - j < window, ``softcap`` > 0 caps the scaled logits as
    cap * tanh(s / cap); ``sm_scale`` defaults to d ** -0.5. Scores,
    softmax and the PV sum are fp32, rounded once. A CPU ``q`` runs the
    plain version; a CUDA one the kernel. Unlike the reference's wrapper
    nothing is padded: the kernel masks ragged tails itself."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, d]")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [B, Sk, Hkv, d] matching q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, sm_scale=scale, causal=causal,
                                   window=window, softcap=softcap)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not one of {HEAD_DIMS}")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, tuple(DTYPES), 4)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, sq, k.shape[1], hq, hkv, d, scale,
                      int(causal), int(window), float(softcap),
                      DTYPES[q.dtype], stream_of(q))
    return out
