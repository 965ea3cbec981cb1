"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

The source holds two bodies, and the wrapper picks one from the dtype
and head dim alone, before the launch:

* bfloat16 with d in ``WGMMA_HEAD_DIMS`` (64, 128, 256) -> the Hopper
  body ``flash_attention_wgmma`` (TMA ring, wgmma products);
* float32 at any head dim, and bfloat16 with d = 16 or 32 -> the FMA
  body ``flash_attention`` (fp32 products on the CUDA cores).

There is no fallback between them: a body that fails to build or launch
raises. Each body counts its own launches (``WGMMA``, ``FMA``);
``KERNEL.launches`` is their sum.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import Bodies, Kernel, check_tensor, stream_of
from repro_torch.kernels.flash_attention.ref import ref_flash_attention
from repro_torch.roofline.analysis import record_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_float]
FMA = Kernel("flash_attention", "flash_attention",
             _ARGS + [ctypes.c_int, ctypes.c_void_p])
WGMMA = Kernel("flash_attention", "flash_attention_wgmma",
               _ARGS + [ctypes.c_void_p])
KERNEL = Bodies(FMA, WGMMA)


def body_of(dtype: torch.dtype, d: int) -> Kernel:
    """The body a CUDA call with this dtype and head dim launches."""
    return WGMMA if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else FMA


def causal_pairs(sq: int, sk: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention with queries and
    keys at positions 0..: query i sees keys j <= i (and i - j < window
    when window > 0), of the sk there are."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention over positions 0.. of both sequences.

    q [B, Sq, Hq, d]; k, v [B, Sk, Hkv, d] with Hq % Hkv == 0, all of
    one dtype (float32 or bfloat16); returns [B, Sq, Hq, d] in q's
    dtype. ``causal`` keeps keys j <= i, ``window`` > 0 keeps
    i - j < window, ``softcap`` > 0 caps the scaled logits as
    cap * tanh(s / cap); ``sm_scale`` defaults to d ** -0.5. Scores,
    softmax statistics and the PV sum are fp32 and the output is
    rounded once. A CPU ``q`` runs the plain version (fp32 throughout);
    a CUDA one the kernel body that ``body_of`` names; a ``meta`` one
    (the dry-run) only the output's shape. Each launch reports its work
    to the cost model (``roofline.analysis``): q, k, v and the output
    once, 4 d FLOPs a query head and unmasked pair. The Hopper body
    (bfloat16, d = 64, 128, 256) rounds P to bfloat16 for the PV product,
    as the reference model's prefill does on its matrix unit, which
    moves the output by at most ``ref.p_rounding_bound`` from the plain
    version; the FMA body keeps P fp32. Unlike the reference's wrapper
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
    body = body_of(q.dtype, d)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    sk = k.shape[1]
    flops = 4 * d * hq * b * (causal_pairs(sq, sk, window) if causal
                              else sq * sk)
    work = (body.symbol, nbytes, flops,
            "bfloat16" if body is WGMMA else "float32")
    if q.device.type == "meta":
        record_kernel(*work)
        return torch.empty_like(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, tuple(DTYPES), 4)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], hq, hkv, d, scale, int(causal), int(window),
            float(softcap))
    with torch.cuda.device(q.device):
        if body is WGMMA:
            # grid (B * Hq, q tiles of 128); TMA reads 16-byte aligned rows
            if -(-sq // 128) > 65535:
                raise ValueError(f"Sq = {sq} exceeds the grid's 65535 "
                                 "tiles of 128 rows")
            if any(t.data_ptr() % 16 for t in (q, k, v)):
                raise ValueError("q, k and v must be 16-byte aligned")
            WGMMA.launch(*args, stream_of(q))
        else:
            if b * hq > 65535:
                raise ValueError(f"B * Hq = {b * hq} exceeds the grid's "
                                 "65535")
            FMA.launch(*args, DTYPES[q.dtype], stream_of(q))
    record_kernel(*work)
    return out
