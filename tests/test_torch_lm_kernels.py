"""repro_torch's flash-attention kernel package (the plain version and
the CPU route of the wrapper) against the reference's Pallas kernel in
interpret mode and its dense oracle.

Tolerances are the reference's own for this kernel
(``tests/test_kernels.py``): float32 atol = rtol = 2e-5 (sums in
another order), bfloat16 2e-2 (both sides round the output once, from
fp32 results of different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops, ref as jref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
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
