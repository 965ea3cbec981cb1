"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention with the same variants (the port of the reference's
``flash_attention/ref.py``), its grouped-query form, and the bounds,
per element and normwise, that rounding P to bfloat16 puts on the
kernel's distance from it."""
from __future__ import annotations

import torch

NEG_INF = -1e30        # the reference's mask constant
BF16_UNIT_ROUNDOFF = 2.0 ** -8
ORDER_TERM = 1e-5      # two fp32 summation orders, as in the f32 gate


def attention_probs(q: torch.Tensor, k: torch.Tensor, *, sm_scale: float,
                    causal: bool = False, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0
                    ) -> torch.Tensor:
    """q [BH, Sq, d], k [BH, Sk, d] -> the fp32 softmax P [BH, Sq, Sk]:
    scores in fp32, masked with -1e30 (a row with no key left averages
    every key), normalised. Query i sits at position ``q_offset + i``,
    key j at j."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    sq, sk = s.shape[-2], s.shape[-1]
    q_pos = torch.arange(q_offset, q_offset + sq, device=s.device)[:, None]
    k_pos = torch.arange(sk, device=s.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    return p / torch.where(denom == 0, 1.0, denom)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, causal: bool = False, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q [BH, Sq, d], k, v [BH, Sk, d] -> [BH, Sq, d] in q's dtype: the
    whole score matrix in fp32 (``attention_probs``), fp32 PV, one
    rounding."""
    p = attention_probs(q, k, sm_scale=sm_scale, causal=causal,
                        window=window, softcap=softcap, q_offset=q_offset)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """[B, S, H, d] -> [B * Hq, S, d] with query head h beside kv head
    h // (Hq // Hkv), as the reference's wrapper folds the group."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b * hkv * g, sq, d)
    kg = k.permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, sk, d).reshape(
        b * hkv * g, sk, d)
    vg = v.permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, g, sk, d).reshape(
        b * hkv * g, sk, d)
    return qg, kg, vg


def _ungrouped(x: torch.Tensor, b: int, hq: int) -> torch.Tensor:
    """[B * Hq, Sq, d] -> [B, Sq, Hq, d]."""
    return x.reshape(b, hq, x.shape[1], x.shape[2]).permute(
        0, 2, 1, 3).contiguous()


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """Grouped-query form: q [B, Sq, Hq, d], k, v [B, Sk, Hkv, d] ->
    [B, Sq, Hq, d]; query head h reads kv head h // (Hq // Hkv). The
    group is folded into the batch-heads axis as the reference's
    wrapper folds it. ``q_offset`` places the queries at positions
    ``q_offset..`` (the last rows of a longer prefill)."""
    qg, kg, vg = _grouped(q, k, v)
    out = ref_attention(qg, kg, vg, sm_scale=sm_scale, causal=causal,
                        window=window, softcap=softcap, q_offset=q_offset)
    return _ungrouped(out, q.shape[0], q.shape[2])


def ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (7 stored mantissa bits), fp32."""
    e = torch.floor(torch.log2(torch.clamp(x.float().abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _plain_parts(q, k, v, **kw):
    """The plain fp32 softmax P, V in fp32 (grouped, [B * Hq, ...]) and
    the plain output rounded to q's dtype."""
    qg, kg, vg = _grouped(q, k, v)
    p = attention_probs(qg, kg, **kw)
    vf = vg.float()
    return p, vf, torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def p_rounding_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     sm_scale: float, causal: bool = True, window: int = 0,
                     softcap: float = 0.0, q_offset: int = 0
                     ) -> torch.Tensor:
    """Per-element bound [B, Sq, Hq, d] (fp32) on |o - o_plain| for an
    attention that rounds P to bfloat16 for the PV product, with o_plain
    this module's ``ref_flash_attention`` (arguments as there):

        ulp_bf16(o_plain) + 2^-8 * (P @ |V|) + 1e-5

    with P the plain fp32 softmax. Why: with the row's running max and
    its sum l kept fp32 (l summed from the unrounded p), rounding each
    p to bfloat16 changes it by at most 2^-8 p (bfloat16's unit
    roundoff), so the numerator sum_j p_j v_j moves by at most
    2^-8 sum_j p_j |v_j|, which divided by l is 2^-8 (P @ |V|) for the
    normalised P. Each side rounds its output to bfloat16 once, which
    costs one ulp of o_plain between them; the two fp32 summation
    orders add the order term 1e-5, the float32 gate's. This is the
    arithmetic of the reference model's own bfloat16 prefill
    (``p.astype(v.dtype)`` into an fp32-accumulated product) and of
    the Pallas kernel on the TPU's matrix unit.

    It is a worst case: every p rounded the same way. On long rows it
    grows with the mean of |v| while the real error, signed, shrinks, so
    it cannot see a small fault there (one 64-key tile dropped from a
    32k row); ``p_rounding_norm_bound`` can."""
    p, vf, o_plain = _plain_parts(q, k, v, sm_scale=sm_scale, causal=causal,
                                  window=window, softcap=softcap,
                                  q_offset=q_offset)
    bound = ulp_bf16(o_plain) + BF16_UNIT_ROUNDOFF * torch.einsum(
        "bqk,bkd->bqd", p, vf.abs()) + ORDER_TERM
    return _ungrouped(bound, q.shape[0], q.shape[2])


def p_rounding_norm_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, sm_scale: float, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          q_offset: int = 0) -> float:
    """Bound on the 2-norm of o - o_plain over all its elements, for the
    same attention as ``p_rounding_bound`` (arguments as there):

        ||ulp_bf16(o_plain)||_2 + 2^-8 sqrt(sum_ijc p_ij^2 v_jc^2)
            + 1e-5 sqrt(n)

    for n output elements. The output roundings (one ulp an element at
    most) and the order term are bounded element by element as in
    ``p_rounding_bound``, so normwise by their 2-norms. The rounding of
    P moves element (i, c) by e_ic = sum_j d_ij p_ij v_jc with d_ij
    p_ij's relative rounding error: |d_ij| <= 2^-8, and round-to-nearest
    errors are of either sign and unrelated from one p to the next, so
    E d_ij^2 <= 2^-16 / 3 and E ||e||^2 <= (2^-16 / 3) sum p^2 v^2.
    Over the many rows of a call ||e||^2 stays near its mean, so the
    middle term, sqrt(3) times its root-mean-square, holds it. Unlike
    the per-element worst case this shrinks as sqrt(sum p^2) does on
    long rows: a fault of one tile of keys in a 32k row stands out."""
    p, vf, o_plain = _plain_parts(q, k, v, sm_scale=sm_scale, causal=causal,
                                  window=window, softcap=softcap,
                                  q_offset=q_offset)
    spread = torch.einsum("bqk,bk->", p * p, vf.square().sum(-1))
    return float(ulp_bf16(o_plain).norm() +
                 BF16_UNIT_ROUNDOFF * spread.sqrt() +
                 ORDER_TERM * o_plain.numel() ** 0.5)
