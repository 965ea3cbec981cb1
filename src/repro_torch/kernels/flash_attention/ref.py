"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention with the same variants (the port of the reference's
``flash_attention/ref.py``), and its grouped-query form."""
from __future__ import annotations

import torch

NEG_INF = -1e30        # the reference's mask constant


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, causal: bool = False, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q [BH, Sq, d], k, v [BH, Sk, d] -> [BH, Sq, d] in q's dtype: the
    whole score matrix in fp32, masked with -1e30 (a row with no key
    left averages every key), softmax, fp32 PV, one rounding."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    sq, sk = s.shape[-2], s.shape[-1]
    q_pos = torch.arange(sq, device=s.device)[:, None]
    k_pos = torch.arange(sk, device=s.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, 1.0, denom)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> torch.Tensor:
    """Grouped-query form: q [B, Sq, Hq, d], k, v [B, Sk, Hkv, d] ->
    [B, Sq, Hq, d]; query head h reads kv head h // (Hq // Hkv). The
    group is folded into the batch-heads axis as the reference's
    wrapper folds it (a view of k and v, not a repeated copy)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b * hkv * g, sq, d)
    kg = k.permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, sk, d).reshape(
        b * hkv * g, sk, d)
    vg = v.permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, sk, d).reshape(
        b * hkv * g, sk, d)
    out = ref_attention(qg, kg, vg, sm_scale=sm_scale, causal=causal,
                        window=window, softcap=softcap)
    return out.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4).reshape(
        b, sq, hq, d)
