"""repro_torch's flash-attention kernel package (the plain version and
the CPU route of the wrapper) against the reference's Pallas kernel in
interpret mode and its dense oracle.

Tolerances are the reference's own for this kernel
(``tests/test_kernels.py``): float32 atol = rtol = 2e-5 (sums in
another order), bfloat16 2e-2 (both sides round the output once, from
fp32 results of different orders).

The gate of the kernel's Hopper body, ``ref.p_rounding_bound`` (one
bfloat16 ulp of the plain output + 2^-8 (P @ |V|) + 1e-5), is held here
against the reference model's own bfloat16 attention paths, which round
P to bfloat16 for the PV product as that body does: every element of
theirs lies within it of the port's fp32 plain version, and the whole
difference within the normwise ``ref.p_rounding_norm_bound``, which a
tile of keys dropped from a 32k row exceeds though every element of
that fault stays within the per-element bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops, ref as jref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.models.layers import _attention_blocked, _attention_dense
from repro_torch.kernels.flash_attention import ops as tops, ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shapes, dtype: str, seed: int):
    """The same numpy draws as (jax arrays, torch tensors), rounded to
    the dtype once."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", (16, 64))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (64, 50.0)])
def test_ref_attention_matches_reference_oracle(dtype, d, causal, window,
                                                softcap):
    (jq, jk, jv), (tq, tk, tv) = _inputs([(3, 96, d)] * 3, dtype, seed=d)
    kw = dict(sm_scale=d ** -0.5, causal=causal, window=window,
              softcap=softcap)
    got = tref.ref_attention(tq, tk, tv, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jref.ref_attention(jq, jk, jv, **kw), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,s", [(16, 128), (64, 128), (256, 64)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (0, 50.0), (32, 50.0)])
def test_cpu_route_matches_pallas_interpret(dtype, d, s, window, softcap):
    """The wrapper on CPU tensors (one kv head per query head, so the
    [B, S, H, d] call is the kernel's [BH, S, d]) against the Pallas
    kernel run in interpret mode, causal, 32-row tiles."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(2, s, d)] * 3, dtype, seed=s + d)
    want = flash_attention_pallas(jq, jk, jv, sm_scale=d ** -0.5,
                                  causal=True, window=window,
                                  softcap=softcap, block_q=32, block_k=32,
                                  interpret=True)
    got = tops.flash_attention(tq.permute(1, 0, 2)[None],
                               tk.permute(1, 0, 2)[None],
                               tv.permute(1, 0, 2)[None], causal=True,
                               window=window, softcap=softcap)
    assert got.shape == (1, s, 2, d) and got.dtype == DTYPES[dtype][1]
    _close(got[0].permute(1, 0, 2), want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,hq,hkv,d", [(2, 100, 4, 2, 16),
                                           (1, 75, 8, 4, 64),
                                           (2, 33, 4, 1, 32)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 50.0)])
def test_gqa_wrapper_matches_reference_wrapper(dtype, b, sq, hq, hkv, d,
                                               window, softcap):
    """Grouped heads and a length that is no multiple of the
    reference's 64-row block (which its wrapper pads and the port's
    does not)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, sq, hq, d), (b, sq, hkv, d), (b, sq, hkv, d)], dtype, seed=sq)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                softcap=softcap, block_q=64, block_k=64,
                                interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window,
                               softcap=softcap)
    assert got.shape == (b, sq, hq, d)
    _close(got, want, DTYPES[dtype][2])


def test_plain_gqa_form_reads_the_grouped_kv_head():
    """Query head h attends with kv head h // (Hq // Hkv): the grouped
    form equals the per-head dense attention with k, v repeated."""
    _, (q, k, v) = _inputs([(1, 40, 6, 16), (1, 40, 2, 16), (1, 40, 2, 16)],
                           "float32", seed=5)
    got = tref.ref_flash_attention(q, k, v, sm_scale=0.25, causal=True,
                                   window=8, softcap=20.0)
    for h in range(6):
        want = tref.ref_attention(q[:, :, h], k[:, :, h // 3],
                                  v[:, :, h // 3], sm_scale=0.25,
                                  causal=True, window=8, softcap=20.0)
        torch.testing.assert_close(got[:, :, h], want, atol=1e-6, rtol=1e-6)


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match=r"\[B, S, H, d\]"):
        tops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="matching q"):
        tops.flash_attention(q, k[..., :8], k[..., :8])
    with pytest.raises(ValueError, match="matching q"):
        tops.flash_attention(q, k, k[:, :4])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention(q, torch.zeros(1, 8, 3, 16),
                             torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match=">= 0"):
        tops.flash_attention(q, k, k, window=-1)
    with pytest.raises(ValueError, match=">= 0"):
        tops.flash_attention(q, k, k, softcap=-2.0)


# (B, S, Hq, Hkv, d, window, softcap): d = 256 / 128 / 64, grouped and
# ungrouped heads, a window, softcap 0 and 50, lengths off every block
P_BOUND_CASES = [(1, 300, 4, 2, 256, 0, 50.0), (2, 200, 4, 4, 64, 33, 0.0),
                 (1, 257, 8, 4, 128, 0, 0.0), (1, 150, 6, 2, 256, 70, 50.0)]


def _bf16_case(b, s, hq, hkv, d, seed):
    return _inputs([(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)],
                   "bfloat16", seed)


@pytest.mark.parametrize("path", ("blocked", "dense"))
@pytest.mark.parametrize("b,s,hq,hkv,d,window,cap", P_BOUND_CASES)
def test_p_rounding_bound_holds_for_reference_bf16_paths(path, b, s, hq,
                                                         hkv, d, window,
                                                         cap):
    """The reference model's bfloat16 prefill attention (bf16 operands,
    fp32 accumulation, P rounded to bf16 for the PV product), blocked
    with 64-key blocks so that several run, or dense, lies within
    ``p_rounding_bound`` of the port's fp32 plain version at every
    element, and within ``p_rounding_norm_bound`` normwise."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_case(b, s, hq, hkv, d, seed=s + d)
    pos = jnp.arange(s, dtype=jnp.int32)
    kw = dict(q_positions=pos, k_positions=pos, window=window,
              attn_softcap=cap, scale=d ** -0.5, kv_mask=None)
    if path == "blocked":
        out = _attention_blocked(jq, jk, jv, block_k=64, **kw)
    else:
        out = _attention_dense(jq, jk, jv, **kw)
    got = torch.from_numpy(np.asarray(out, np.float32))
    tkw = dict(sm_scale=d ** -0.5, causal=True, window=window, softcap=cap)
    want = tref.ref_flash_attention(tq, tk, tv, **tkw).float()
    bound = tref.p_rounding_bound(tq, tk, tv, **tkw)
    assert bound.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    norm_bound = tref.p_rounding_norm_bound(tq, tk, tv, **tkw)
    assert float(err.norm()) <= norm_bound, float(err.norm()) / norm_bound
    # and the fp32-P gate of the FMA body (one ulp + 1e-5) does not hold
    # for this arithmetic: the restated bound is needed, not a luxury
    assert bool((err > tref.ulp_bf16(want) + 1e-5).any())


@pytest.mark.parametrize("b,s,hq,hkv,d,window,cap", P_BOUND_CASES)
def test_p_rounding_bound_is_derived_not_fitted(b, s, hq, hkv, d, window,
                                                cap):
    """P's rows sum to 1, so the bound never exceeds one ulp of the
    plain output + 2^-8 max|v| + 1e-5 (the factor 1 + 2^-16 covers the
    fp32 rounding of P's row sums)."""
    _, (tq, tk, tv) = _bf16_case(b, s, hq, hkv, d, seed=s)
    tkw = dict(sm_scale=d ** -0.5, causal=True, window=window, softcap=cap)
    want = tref.ref_flash_attention(tq, tk, tv, **tkw)
    bound = tref.p_rounding_bound(tq, tk, tv, **tkw)
    vmax = float(tv.float().abs().max())
    ceiling = tref.ulp_bf16(want) + 2.0 ** -8 * vmax * (1 + 2.0 ** -16) + 1e-5
    assert bool((bound <= ceiling).all())
    assert bool((bound >= tref.ulp_bf16(want) + 1e-5).all())


@pytest.mark.parametrize("cap", (50.0, 0.0))
def test_p_rounding_norm_bound_sees_a_dropped_tile(cap):
    """The last 64 rows of a 32k causal prefill at gemma2-2b's head dim
    256 with one 64-key tile (keys 192..255) left out of every row, as
    the card checks the tail of that prefill: each element of that fault
    stays within the per-element worst case, but the whole of it lies
    outside the normwise bound, which the reference's own bfloat16
    paths meet with room to spare."""
    s, d = 32768, 256
    _, (q, k, v) = _inputs([(1, 64, 2, d), (1, s, 1, d), (1, s, 1, d)],
                           "bfloat16", seed=s + d)
    kw = dict(sm_scale=d ** -0.5, causal=True, softcap=cap, q_offset=s - 64)
    want = tref.ref_flash_attention(q, k, v, **kw).float()
    kept = torch.ones(s, dtype=torch.bool)
    kept[192:256] = False
    qg, kg, vg = tref._grouped(q, k, v)
    p = tref.attention_probs(qg, kg, **kw) * kept
    p = p / p.sum(-1, keepdim=True)
    dropped = tref._ungrouped(torch.einsum("bqk,bkd->bqd", p, vg.float())
                              .bfloat16(), 1, 2).float()
    err = dropped - want
    assert bool((err.abs() <= tref.p_rounding_bound(q, k, v, **kw)).all())
    assert float(err.norm()) > 2 * tref.p_rounding_norm_bound(q, k, v, **kw)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 50.0),
                                               (True, 24, 0.0),
                                               (False, 0, 30.0)])
def test_plain_q_offset_is_the_tail_of_the_whole(causal, window, cap):
    """Queries placed at ``q_offset..`` give the last rows of the whole
    attention (how the card checks the tail of a 32k prefill), and the
    bound of those rows is the tail of the whole bound."""
    _, (q, k, v) = _inputs([(2, 90, 4, 32), (2, 90, 2, 32), (2, 90, 2, 32)],
                           "float32", seed=9)
    kw = dict(sm_scale=32 ** -0.5, causal=causal, window=window,
              softcap=cap)
    whole = tref.ref_flash_attention(q, k, v, **kw)
    tail = tref.ref_flash_attention(q[:, 70:], k, v, q_offset=70, **kw)
    torch.testing.assert_close(tail, whole[:, 70:], atol=1e-6, rtol=1e-6)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    torch.testing.assert_close(
        tref.p_rounding_bound(qb[:, 70:], kb, vb, q_offset=70, **kw),
        tref.p_rounding_bound(qb, kb, vb, **kw)[:, 70:], atol=1e-6,
        rtol=1e-6)
