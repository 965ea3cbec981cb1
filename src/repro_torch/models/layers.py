"""Shared neural-net layers, the port of ``repro.models.layers``: what
the recsys model (initialisers, the plain MLP tower) and the LM
(norms, rotary embeddings, attention, gated MLPs, the losses) need.
Random initialisation always draws from an explicit
``torch.Generator``.

Rounding follows the reference: norms and rotary embeddings compute in
float32 and cast back; attention scores are float32 whatever the model
dtype. Prefill attention (every ``Sq > 1`` call over fresh keys at
positions 0..) runs through the flash-attention kernel, MLA's too (its
head dims zero-padded to one the kernel takes), through the kernel's
autograd entry (``kernels.autograd``): with a gradient to take, its
backward differentiates ``attention_blocked``. The rest, the decode step
over the caches above all, goes through ``attention_dense``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.autograd import flash_attention
from repro_torch.kernels.flash_attention.blocked import (  # noqa: F401
    NEG_INF, attention_blocked, attention_scores_mask, softcap)
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS


def from_numpy(a) -> torch.Tensor:
    """A host array to a tensor; an ml_dtypes bfloat16 array (what a
    JAX bfloat16 array becomes in numpy) keeps its exact bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def normal_init(shape, std: float, dtype: torch.dtype, *,
                generator: torch.Generator, device=None) -> torch.Tensor:
    """N(0, std²) drawn in float32, then cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def mlp_params(dims: list[int], dtype: torch.dtype, *,
               generator: torch.Generator, device=None) -> dict:
    """``{"ws": [W_i], "bs": [b_i]}`` for the layers ``dims[i] ->
    dims[i+1]``: W ~ N(0, 1/din), b = 0."""
    ws, bs = [], []
    for din, dout in zip(dims[:-1], dims[1:]):
        ws.append(normal_init((din, dout), din ** -0.5, dtype,
                              generator=generator, device=device))
        bs.append(torch.zeros((dout,), dtype=dtype, device=device))
    return {"ws": ws, "bs": bs}


def mlp_apply(params, x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Plain MLP tower: ``x @ W + b`` per layer, with ``act`` (relu or
    silu) between layers and none after the last."""
    n = len(params["ws"])
    for i, (w, b) in enumerate(zip(params["ws"], params["bs"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x) if act == "relu" else F.silu(x)
    return x


# --------------------------------------------------------------------------
# Norms and rotary position embeddings
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32, cast back to x's dtype; ``plus_one`` uses the
    (1 + w) parameterisation (gemma)."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, d]; positions [S] (shared) or [B, S] (per request).
    Rotates the (first, second) halves, the half-rotation convention,
    in float32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs            # [.., S, d/2]
    if positions.dim() == 1:
        cos, sin = torch.cos(angles)[None, :, None], \
            torch.sin(angles)[None, :, None]
    else:
        cos, sin = torch.cos(angles)[:, :, None], \
            torch.sin(angles)[:, :, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def attention_dense(q, k, v, *, q_positions, k_positions, window: int,
                    attn_softcap: float, scale: float, kv_mask=None
                    ) -> torch.Tensor:
    """The direct S x S scores path (the reference's ``_attention_dense``):
    q [B, Sq, Hq, d], k [B, Sk, Hkv, d], v [B, Sk, Hkv, dv]. Scores in
    float32 (the operands are upcast, as the reference's products
    accumulate in f32), p rounded to v's dtype before the PV product,
    one rounding of the output to q's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    s = softcap(s, attn_softcap)
    mask = attention_scores_mask(q_positions, k_positions, window)
    if mask.dim() == 2:
        mask = mask[None]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_positions: torch.Tensor,
                         k_positions: torch.Tensor, window: int = 0,
                         attn_softcap: float = 0.0,
                         sm_scale: float | None = None,
                         kv_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """GQA attention. q [B, Sq, Hq, d]; k [B, Sk, Hkv, d]; v [B, Sk, Hkv,
    dv] (MLA: dv != d).

    A prefill over fresh keys (``Sq > 1``, shared 1-D positions,
    ``k_positions is q_positions``, no ``kv_mask``) is exactly the
    flash kernel's contract: positions 0.. on both sides, causal, the
    layer's window and softcap. It goes to ``flash_attention``, the
    kernel's autograd entry (the kernel on a CUDA tensor, its plain
    version on a CPU one; with grad on and q, k or v requiring it, a
    backward that differentiates ``attention_blocked``). Head dims the
    kernel does not take (MLA's d = 96, dv = 64) are zero-padded to the
    smallest of ``HEAD_DIMS`` that holds both, with the scale given for
    the true d, and the output cut back to dv: a zero column adds an
    exact zero to every dot product and to the PV sum. Everything else,
    the decode step over the caches' stored positions above all, goes to
    ``attention_dense``."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if (q.shape[1] > 1 and q_positions.dim() == 1
            and k_positions is q_positions and kv_mask is None):
        kw = dict(sm_scale=scale, causal=True, window=int(window),
                  softcap=attn_softcap)
        d, dv = q.shape[-1], v.shape[-1]
        if d == dv and d in HEAD_DIMS:
            return flash_attention(q, k, v, **kw)
        fits = [h for h in HEAD_DIMS if h >= max(d, dv)]
        if not fits:
            raise ValueError(f"head dims {d} / {dv} exceed the flash "
                             f"kernel's largest, {HEAD_DIMS[-1]}")
        dp = fits[0]
        out = flash_attention(F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d)),
                              F.pad(v, (0, dp - dv)), **kw)
        return out[..., :dv]
    return attention_dense(q, k, v, q_positions=q_positions,
                           k_positions=k_positions, window=int(window),
                           attn_softcap=attn_softcap, scale=scale,
                           kv_mask=kv_mask)


# --------------------------------------------------------------------------
# Gated MLPs
# --------------------------------------------------------------------------

def gated_mlp_apply(params: dict, x: torch.Tensor,
                    act: str = "silu") -> torch.Tensor:
    """SwiGLU (``silu``) / GeGLU (``gelu``, the tanh approximation, as
    ``jax.nn.gelu`` defaults to) feed-forward."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (a * up) @ params["w_down"]


def gated_mlp_params(d_model: int, d_ff: int, dtype: torch.dtype, *,
                     generator: torch.Generator, device=None) -> dict:
    g = {"generator": generator, "device": device}
    return {
        "w_gate": normal_init((d_model, d_ff), d_model ** -0.5, dtype, **g),
        "w_up": normal_init((d_model, d_ff), d_model ** -0.5, dtype, **g),
        "w_down": normal_init((d_ff, d_model), d_ff ** -0.5, dtype, **g),
    }


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-level cross-entropy; logits [*, V] in any dtype (float32
    inside), labels [*]. With ``mask`` the mean over its weight, at
    least 1."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _chunk_nll(xc, lc, head, final_softcap: float):
    """One chunk's summed NLL over its valid labels (>= 0) and their
    count, both float32."""
    logits = softcap((xc @ head).float(), final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def chunked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, *, final_softcap: float = 0.0,
                    seq_chunk: int = 512) -> torch.Tensor:
    """Memory-lean LM cross-entropy, the reference's: x [B, S, D] final
    hidden states, head [D, V], labels [B, S]. The sequence goes in
    chunks of ``seq_chunk`` tokens (the last padded with label -1); a
    chunk's logits are the head product in the model dtype, then float32
    and the final softcap, and give its NLL sum (logsumexp minus the
    gold logit) over the valid labels. The loss is that total over
    ``max(count, 1)``. With grad on, each chunk runs under
    ``checkpoint``, so the [B, S, V] float32 logits never exist: the
    backward recomputes one [B, chunk, V] tile at a time."""
    b, s, _ = x.shape
    nchunk = -(-s // seq_chunk)
    pad = nchunk * seq_chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for c in range(nchunk):
        cut = slice(c * seq_chunk, (c + 1) * seq_chunk)
        args = (x[:, cut], labels[:, cut], head, final_softcap)
        t, n = checkpoint(_chunk_nll, *args, use_reentrant=False) if remat \
            else _chunk_nll(*args)
        total = total + t
        count = count + n
    return total / torch.clamp(count, min=1.0)
