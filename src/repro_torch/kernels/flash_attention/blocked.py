"""Blocked online-softmax attention: the reference's
``_attention_blocked``, the XLA path beside its flash kernel. A loop
over kv blocks keeps a running max, sum and accumulator in float32, so
the S x S scores never exist, and with grad on each block is a
``checkpoint``: its backward holds one block's score tile at a time.
This is what the flash kernel's autograd wrapper differentiates for its
backward (``kernels.autograd``), and what ``models.layers`` re-exports
for the model's own use."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ref import NEG_INF


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0.0 else x


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: int) -> torch.Tensor:
    """Causal (+ sliding ``window``, 0 = none) mask. Positions [S] give
    [Sq, Sk]; [B, S] give [B, Sq, Sk]. Negative k positions mark empty
    cache slots and are always masked."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    mask = (q >= k) & (k >= 0)
    if window > 0:
        mask &= (q - k) < window
    return mask


def _kv_block(qf, kb, vb, kpos_b, kvm_b, m_run, l_run, acc, q_positions,
              window: int, attn_softcap: float, scale: float):
    """One kv block of ``attention_blocked``: the block's fp32 scores,
    masked, folded into the running (max, sum, accumulator)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb.float()) * scale
    s = softcap(s, attn_softcap)
    mask = attention_scores_mask(q_positions, kpos_b, window)
    if mask.dim() == 2:
        mask = mask[None]
    if kvm_b is not None:
        mask = mask & kvm_b[:, None, :]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    alpha = torch.exp(m_run - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_run * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, acc


def attention_blocked(q, k, v, *, q_positions, k_positions, window: int,
                      attn_softcap: float, scale: float, kv_mask=None,
                      block_k: int = 512) -> torch.Tensor:
    """Blocked online-softmax attention, the reference's
    ``_attention_blocked`` (its XLA path of the flash kernel), with the
    arguments and shapes of ``attention_dense``.

    A loop over kv blocks of ``block_k`` keys keeps the running max m,
    sum l and accumulator in float32; the S x S scores never exist. The
    keys of a ragged last block are padded with position -1 (always
    masked); p is rounded to v's dtype for the PV product, as the
    reference's is; a row that no key reaches is divided by 1. With
    grad on, each block body runs under ``checkpoint`` (the reference's
    ``jax.checkpoint(nothing_saveable)``), so the backward recomputes
    one [B, Hkv, G, Sq, block_k] score tile at a time."""
    b, sq, hq, d = q.shape
    dv = v.shape[-1]
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nblk = -(-sk // block_k)
    pad = nblk * block_k - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    kpos = F.pad(k_positions, (0, pad), value=-1)
    kvm = None if kv_mask is None else F.pad(kv_mask, (0, pad))
    qf = q.reshape(b, sq, hkv, g, d).float()
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((b, hkv, g, sq), dtype=torch.float32,
                       device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    remat = torch.is_grad_enabled()
    for i in range(nblk):
        cut = slice(i * block_k, (i + 1) * block_k)
        args = (qf, kp[:, cut], vp[:, cut], kpos[..., cut],
                None if kvm is None else kvm[:, cut], m, lsum, acc,
                q_positions, int(window), attn_softcap, scale)
        if remat:
            m, lsum, acc = checkpoint(_kv_block, *args, use_reentrant=False)
        else:
            m, lsum, acc = _kv_block(*args)
    lsum = torch.where(lsum == 0.0, 1.0, lsum)
    out = acc / lsum[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)
