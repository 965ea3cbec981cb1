"""repro_torch's LM training attention and losses against the
reference's, on the CPU: the blocked attention (values and gradients,
against ``_attention_blocked`` and ``_attention_dense``), the flash
kernel's autograd wrapper (whose backward differentiates
``attention_blocked``; on the CPU its forward is the kernel's plain
version), the cross-entropy and the chunked LM loss. Tolerances
(float32): 1e-5 (the same fp32 terms summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import autograd as kernel_grad
from repro_torch.models import layers as TL

from _lm_train_common import _np, _rand


# --------------------------------------------------------------------------
# Blocked attention and the flash kernel's autograd wrapper
# --------------------------------------------------------------------------

# (b, sq, hq, hkv, d, dv, window, cap, block_k, masked): block_k 16 on 40
# keys leaves a ragged last block of 8; ``masked`` gives batch row 1 a
# kv_mask with no key at all (a fully-masked row in every block)
ATTN_CASES = {
    "gqa": (2, 40, 4, 2, 16, 16, 0, 0.0, 16, False),
    "window_softcap": (2, 40, 4, 2, 16, 16, 7, 50.0, 16, False),
    "mla_d24_dv16": (1, 40, 4, 4, 24, 16, 0, 0.0, 16, False),
    "one_block": (1, 24, 2, 1, 32, 32, 0, 30.0, 512, False),
    "fully_masked_row": (2, 40, 4, 2, 16, 16, 0, 50.0, 16, True),
}


def _attn_inputs(case: str):
    b, s, hq, hkv, d, dv, window, cap, block_k, masked = ATTN_CASES[case]
    q, k = _rand((b, s, hq, d), 1), _rand((b, s, hkv, d), 2)
    v, cot = _rand((b, s, hkv, dv), 3), _rand((b, s, hq, dv), 4)
    kv_mask = None
    if masked:
        kv_mask = np.ones((b, s), bool)
        kv_mask[1] = False
    kw = dict(window=window, attn_softcap=cap, scale=d ** -0.5)
    return (q, k, v, cot, kv_mask, kw, block_k)


def _reference_attention(fn, q, k, v, cot, kv_mask, kw, **extra):
    """(out, (dq, dk, dv)) of a reference attention, float32."""
    pos = jnp.arange(q.shape[1], dtype=jnp.int32)
    jm = None if kv_mask is None else jnp.asarray(kv_mask)

    def f(q_, k_, v_):
        return fn(q_, k_, v_, q_positions=pos, k_positions=pos,
                  kv_mask=jm, **kw, **extra)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(cot)),
                     argnums=(0, 1, 2))(*args)
    return _np(out), tuple(_np(g) for g in grads)


def _port_blocked(q, k, v, cot, kv_mask, kw, block_k):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    out = TL.attention_blocked(
        qt, kt, vt, q_positions=pos, k_positions=pos,
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
        block_k=block_k, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (qt, kt, vt))
    return _np(out), tuple(_np(g) for g in grads)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_blocked_matches_reference_blocked(case):
    """Values and gradients of ``attention_blocked`` against
    ``_attention_blocked`` at the same block size, f32 within 1e-5."""
    q, k, v, cot, kv_mask, kw, block_k = _attn_inputs(case)
    want = _reference_attention(JL._attention_blocked, q, k, v, cot, kv_mask,
                                kw, block_k=block_k)
    got = _port_blocked(q, k, v, cot, kv_mask, kw, block_k)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for name, g, w in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", [c for c in ATTN_CASES
                                  if c != "fully_masked_row"])
def test_attention_blocked_matches_reference_dense(case):
    """The same against ``_attention_dense``, the reference's S x S path
    (a row that some key reaches: the two paths differ on rows no key
    reaches, where the blocked one averages the padded keys too)."""
    q, k, v, cot, kv_mask, kw, block_k = _attn_inputs(case)
    want = _reference_attention(JL._attention_dense, q, k, v, cot, kv_mask,
                                kw)
    got = _port_blocked(q, k, v, cot, kv_mask, kw, block_k)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for name, g, w in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_attention_blocked_keeps_one_tile_in_backward():
    """Under grad each block body is a checkpoint: the forward saves its
    inputs (q, the block's k, v and positions, the running statistics)
    but no [B, Hkv, G, Sq, block_k] score tile (block_k 8 here, v's
    head dim 16)."""
    q, k, v, cot, kv_mask, kw, _ = _attn_inputs("gqa")
    block_k = 8
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    pos = torch.arange(q.shape[1])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL.attention_blocked(qt, kt, vt, q_positions=pos, k_positions=pos,
                             block_k=block_k, **kw)
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    assert (b, block_k, hkv, 16) in saved
    assert (b, hkv, hq // hkv, s, block_k) not in saved, saved


@pytest.mark.parametrize("case", ("gqa", "window_softcap", "mla_d24_dv16"))
def test_flash_autograd_gradients_are_the_blocked_recompute(case):
    """``kernels.autograd.flash_attention`` on CPU tensors: its forward
    is the kernel's plain version (the reference's dense attention within
    1e-5); its q, k, v gradients are torch.autograd's of
    ``attention_blocked`` on the same inputs bit for bit, and the
    reference's ``jax.grad`` within 1e-5. MLA's d 24 / dv 16 goes in
    zero-padded to 32, as ``multi_head_attention`` sends it."""
    q, k, v, cot, _, kw, _ = _attn_inputs(case)
    want = _reference_attention(JL._attention_dense, q, k, v, cot, None, kw)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    out = TL.multi_head_attention(qt, kt, vt, q_positions=pos,
                                  k_positions=pos, window=kw["window"],
                                  attn_softcap=kw["attn_softcap"],
                                  sm_scale=kw["scale"])
    cot_t = torch.from_numpy(cot)
    grads = torch.autograd.grad((out * cot_t).sum(), (qt, kt, vt))
    np.testing.assert_allclose(_np(out), want[0], atol=1e-5, rtol=1e-5)
    blocked = TL.attention_blocked(qt, kt, vt, q_positions=pos,
                                   k_positions=pos, **kw)
    again = torch.autograd.grad((blocked * cot_t).sum(), (qt, kt, vt))
    for name, g, a, w in zip("qkv", grads, again, want[1]):
        assert torch.equal(g, a), f"d{name}"
        np.testing.assert_allclose(_np(g), w, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_autograd_routes_and_refuses(monkeypatch):
    """``multi_head_attention``'s flash route takes the autograd Function
    only when grad is on and an input requires it (a choice that
    ``kernels.autograd.flash_attention`` alone makes); the wrapper has no
    gradient for non-causal attention."""
    q, k, v, _, _, kw, _ = _attn_inputs("gqa")
    calls = []
    real = kernel_grad._FlashAttention.apply

    def spy(*a):
        calls.append(True)
        return real(*a)

    monkeypatch.setattr(kernel_grad._FlashAttention, "apply", spy)
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    TL.multi_head_attention(qt, kt, vt, q_positions=pos, k_positions=pos)
    assert calls == []
    with torch.no_grad():
        TL.multi_head_attention(qt.requires_grad_(True), kt, vt,
                                q_positions=pos, k_positions=pos)
    assert calls == []
    TL.multi_head_attention(qt, kt, vt, q_positions=pos, k_positions=pos)
    assert calls == [True]
    with pytest.raises(NotImplementedError, match="causal"):
        kernel_grad.flash_attention(qt, kt, vt, causal=False)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", (False, True))
def test_cross_entropy_loss_matches_reference(masked):
    logits, cot = _rand((3, 7, 50), 5), 1.0
    labels = np.random.default_rng(6).integers(0, 50, (3, 7)).astype(np.int32)
    mask = (np.random.default_rng(8).random((3, 7)) < 0.6).astype(np.float32)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want, wgrad = jax.value_and_grad(
        lambda x: JL.cross_entropy_loss(x, jnp.asarray(labels), jm) * cot)(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = TL.cross_entropy_loss(lt, torch.from_numpy(labels), tm)
    (grad,) = torch.autograd.grad(got, lt)
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(_np(grad), _np(wgrad), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("s,chunk,cap", [(37, 16, 30.0), (37, 64, 0.0),
                                         (32, 8, 0.0)])
def test_chunked_lm_loss_matches_reference(s, chunk, cap):
    """Value and gradients to x and head, with a chunk that does not
    divide S (37 = 2 x 16 + 5, padded with label -1) and a label -1 in
    the data."""
    x, head = _rand((2, s, 12), 9), _rand((12, 40), 10) * 0.5
    labels = np.random.default_rng(11).integers(0, 40, (2, s)).astype(
        np.int32)
    labels[0, 3] = -1

    def jloss(x_, h_):
        return JL.chunked_lm_loss(x_, h_, jnp.asarray(labels),
                                  final_softcap=cap, seq_chunk=chunk)
    want, (wx, wh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt, ht = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    got = TL.chunked_lm_loss(xt, ht, torch.from_numpy(labels),
                             final_softcap=cap, seq_chunk=chunk)
    gx, gh = torch.autograd.grad(got, (xt, ht))
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(_np(gx), _np(wx), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(gh), _np(wh), atol=1e-6, rtol=1e-5)
    ref = TL.cross_entropy_loss(
        (xt @ ht).float() if cap == 0 else TL.softcap((xt @ ht).float(), cap),
        torch.from_numpy(np.maximum(labels, 0)),
        torch.from_numpy((labels >= 0).astype(np.float32)))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
