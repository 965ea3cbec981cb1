"""repro_torch's LM training against the reference's, on the CPU: the
blocked attention (values and gradients, against ``_attention_blocked``
and ``_attention_dense``), the flash kernel's autograd wrapper (whose
backward differentiates ``attention_blocked``; on the CPU its forward is
the kernel's plain version), the two losses, ``loss_fn`` on the smoke
configs of all five LMs (the MoE aux loss included), whole AdamW steps
from a carried reference TrainState, remat, the train cells and the
launcher.

As in ``test_torch_lm.py`` the reference's zero norm weights and QKV
biases are drawn from a seeded normal instead, the same numbers for
both packages, so that every parameter takes part.

Tolerances (float32). Attention, the losses and ``loss_fn``'s value:
1e-5 (the same fp32 terms summed in another order). ``loss_fn``'s
gradients: 1e-5 of the leaf's largest |gradient| (a gradient sums many
terms whose fp32 orders differ). AdamW steps, each from the same
carried state on both sides: loss to 1e-6 relative, grad norm to 1e-6
(2^-8 with bf16 moments); m and v within what that gradient gate makes
of them (1e-5 of m's largest, 2e-5 of v's); a parameter within the move
those errors make in the update lr m^ / (sqrt(v^) + eps), worked out
element by element from the reference's m and v, plus its own ulp.
Where sqrt(v) is near 0 that bound grows without limit, as Adam turns
fp32 noise in a near-zero gradient into a move of any size up to the
step's. grok-1's train cell keeps its moments and its 16-microbatch
gradient sum in bfloat16: the sum rounds after each add, at most half an
ulp of a partial sum, and no partial sum exceeds S = sum_j |g_j| (the
microbatch gradients, the port's), so the two sides' sums differ by at
most 16 ulp(S) beyond their inputs; the clip factor moves with the grad
norm's 2^-8; each side's rounding of m and v to bfloat16 adds one ulp.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.data import pipeline as jdp
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamWConfig, \
    adamw as jadamw
from repro_torch.configs import get_arch as tget
from repro_torch.kernels import autograd as kernel_grad
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig, adamw, named

ARCHS = ("gemma2-2b", "qwen2.5-32b", "minicpm3-4b", "grok-1-314b",
         "phi3.5-moe-42b-a6.6b")
MOE = ("grok-1-314b", "phi3.5-moe-42b-a6.6b")
PERTURBED = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "bq", "bk",
             "bv", "q_norm", "kv_norm")
SEQ = 32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rand(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def _reference_params(arch: str) -> tuple:
    """(reference config, port config, the reference's smoke params as
    host arrays with the norms and biases drawn from a seeded normal)."""
    jcfg = jget(arch).make_smoke_config()
    tcfg = tget(arch).make_smoke_config()
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in paths:
        if getattr(path[-1], "key", None) in PERTURBED:
            leaf = rng.normal(0.0, 0.3, leaf.shape).astype(leaf.dtype)
        leaves.append(leaf)
    return jcfg, tcfg, jax.tree_util.tree_unflatten(treedef, leaves)


def _tokens(cfg, b: int, seed: int = 3) -> np.ndarray:
    return jdp.lm_batch(seed, 0, b, SEQ, cfg.vocab)["tokens"]


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


# --------------------------------------------------------------------------
# loss_fn on the five smoke configs
# --------------------------------------------------------------------------

def _reference_loss_and_grads(arch: str, tokens: np.ndarray, seq_chunk: int):
    jcfg, tcfg, tree = _reference_params(arch)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg, seq_chunk=seq_chunk))(
        jax.tree.map(jnp.asarray, tree))
    _, aux = JT.forward_hidden(jax.tree.map(jnp.asarray, tree),
                               batch["tokens"][:, :-1], jcfg)
    grads = TT.flatten(TT.params_from_reference(
        jax.tree.map(np.asarray, grads), tcfg, device="cpu"))
    return tcfg, tree, float(loss), float(aux), grads


@pytest.mark.parametrize("seq_chunk", (512, 12))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, seq_chunk):
    """``loss_fn`` and its gradient to every parameter against the
    reference's ``loss_fn`` (seq_chunk 12 does not divide S = 32); for
    the MoE archs the aux loss is in it and equals the reference's."""
    tokens = _tokens(tget(arch).make_smoke_config(), 2)
    tcfg, tree, want, want_aux, wgrads = _reference_loss_and_grads(
        arch, tokens, seq_chunk)
    params = TT.params_from_reference(tree, tcfg, device="cpu",
                                      requires_grad=True)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss = TT.loss_fn(params, batch, tcfg, seq_chunk=seq_chunk)
    leaves = TT.flatten(params)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert float(loss) == pytest.approx(want, rel=1e-5, abs=1e-6)
    for name, g in grads.items():
        w = _np(wgrads[name])
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    with torch.no_grad():
        _, aux = TT.forward_hidden(params, batch["tokens"][:, :-1], tcfg,
                                   with_aux=True)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-7)
    assert (float(aux) > 0) == (arch in MOE)


@pytest.mark.parametrize("arch", ("gemma2-2b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b"))
def test_remat_gives_equal_gradients(arch):
    """``remat`` on (each block under checkpoint) and off give the same
    loss and gradients, bit for bit: the recompute runs the same ops on
    the same inputs."""
    _, tcfg, tree = _reference_params(arch)
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2))}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = TT.params_from_reference(tree, cfg, device="cpu",
                                          requires_grad=True)
        loss = TT.loss_fn(params, batch, cfg)
        leaves = list(TT.flatten(params).values())
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_remat_recomputes_each_block(monkeypatch):
    """With remat each layer runs twice in a forward and backward (the
    forward, then the checkpoint's recompute), once without."""
    _, tcfg, tree = _reference_params("gemma2-2b")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, 2))}
    calls = []
    real = TT._layer_apply

    def spy(*a, **kw):
        calls.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(TT, "_layer_apply", spy)
    for remat, want in ((False, 4), (True, 8)):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = TT.params_from_reference(tree, cfg, device="cpu",
                                          requires_grad=True)
        loss = TT.loss_fn(params, batch, cfg)
        torch.autograd.grad(loss, list(TT.flatten(params).values()))
        assert len(calls) == want, remat


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_token_matches_reference(arch):
    want = JT.model_flops_per_token(jget(arch).make_config())
    assert TT.model_flops_per_token(tget(arch).make_config()) == want


# --------------------------------------------------------------------------
# Whole train steps from a carried reference TrainState
# --------------------------------------------------------------------------

def _reference_steps(arch: str, n_steps: int, b: int):
    """The reference's ``_build_lm`` train step (AdamW lr 3e-4, the
    arch's moment dtype, its accumulation) on the smoke config, run
    ``n_steps`` times: (port config, the states before and after each
    step as host arrays, each step's metrics)."""
    jcfg, tcfg, tree = _reference_params(arch)
    mod = jget(arch)
    moment = getattr(mod, "MOMENT_DTYPE", None)
    opt = jadamw(JAdamWConfig(lr=3e-4, moment_dtype=moment))
    state = jts.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jts.make_train_step(
        lambda p, bb: JT.loss_fn(p, bb, jcfg), opt,
        accum_steps=getattr(mod, "ACCUM_STEPS", 4), accum_dtype=moment))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for i in range(n_steps):
        state, m = step(state, {"tokens": jnp.asarray(_tokens(jcfg, b, i))})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return tcfg, states, metrics


def _moment_gates(m: np.ndarray, v: np.ndarray, sum_gate=None) -> tuple:
    """The gates of m and v (see the module docstring): the gradient's
    1e-5 of its leaf's largest carried into m = b1 m + (1 - b1) g and
    v = b2 v + (1 - b2) g^2. With bfloat16 moments ``sum_gate`` = (the
    gate of the step's gradient, its magnitude): that moves m by
    (1 - b1) dg and v by (1 - b2) 2 |g| dg, and each side's rounding to
    bfloat16 adds one ulp."""
    dm = 1e-5 * np.abs(m).max() + np.zeros_like(m)
    dv = 2e-5 * np.abs(v).max() + np.zeros_like(v)
    if sum_gate is not None:
        dg, g = sum_gate
        dm = dm + 0.1 * dg + bf16_ulp(m)
        dv = dv + 0.05 * 2 * g * dg + bf16_ulp(v)
    return dm, dv


def _bf16_sum_gate(params: dict, tokens: np.ndarray, cfg, accum: int,
                   grad_norm: float) -> dict:
    """By leaf, (the gate, the magnitude) of the step's gradient g =
    clip * (the bfloat16 sum of the ``accum`` microbatch gradients) /
    accum. Each side's sum rounds after every add, at most half an ulp of
    a partial sum, and no partial sum exceeds S = sum_j |g_j|: the two
    sums differ by at most accum ulp(S) beyond their fp32 inputs' 1e-5.
    The clip factor 1 / max(norm, 1) moves with the norm, by 2^-8 (its
    gate). The microbatch gradients are the port's, on the carried
    parameters."""
    leaves = TT.flatten(params)
    total = {n: 0.0 for n in leaves}
    gsum = {n: 0.0 for n in leaves}
    for chunk in np.split(tokens, accum):
        loss = TT.loss_fn(params, {"tokens": torch.from_numpy(chunk)}, cfg)
        for n, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            total[n] = total[n] + np.abs(_np(g)).astype(np.float64)
            gsum[n] = gsum[n] + _np(g).astype(np.float64)
    clip = min(1.0, 1.0 / grad_norm)
    out = {}
    for n in leaves:
        g = clip * np.abs(gsum[n]) / accum
        dg = clip * (accum * bf16_ulp(total[n]) + 1e-5 * total[n].max()) \
            / accum + 2.0 ** -8 * g
        out[n] = (dg, g)
    return out


def _port_leaves(tree: dict, tcfg) -> dict:
    """A reference state's params, m and v as port leaves by name."""
    cpu = torch.device("cpu")
    return {part: TT.flatten(TT._unstacked(
        tree["params"] if part == "params" else tree["opt"][part], tcfg,
        cpu)) for part in ("params", "m", "v")}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, monkeypatch):
    """3 steps of ``build_cell(arch, "train_4k")``'s step (on the smoke
    config, B = 16 sequences of 32 tokens), each from the reference's
    state before it (``state_from_reference``), against the reference's
    steps under ``jax.jit``: loss, grad norm, params, m and v under the
    module's gates. Each step starts from the same state on both sides,
    so no step inherits the last one's differences."""
    n_steps, b, lr = 3, 16, 3e-4
    tcfg, states, jm = _reference_steps(arch, n_steps, b)
    mod = tget(arch)
    monkeypatch.setattr(mod, "make_config", lambda: tcfg)
    cell = steps.build_cell(arch, "train_4k", device="cpu")
    moment = getattr(mod, "MOMENT_DTYPE", None)
    opt = adamw(AdamWConfig(lr=lr, moment_dtype=moment))
    for i in range(n_steps):
        state = TT.state_from_reference(states[i], tcfg, opt, device="cpu")
        sum_gate = None
        if moment is not None:
            sum_gate = _bf16_sum_gate(state["params"], _tokens(tcfg, b, i),
                                      tcfg, mod.ACCUM_STEPS,
                                      jm[i]["grad_norm"])
        state, m = cell.step(state, {"tokens": _tokens(tcfg, b, i)})
        assert int(state["step"]) == i + 1
        assert float(m["loss"]) == pytest.approx(jm[i]["loss"], rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            jm[i]["grad_norm"], rel=1e-6 if moment is None else 2.0 ** -8)
        before, after = _port_leaves(states[i], tcfg), \
            _port_leaves(states[i + 1], tcfg)
        got = {"params": named(state["params"]), **state["opt"]}
        bc1, bc2 = 1 - 0.9 ** (i + 1), 1 - 0.95 ** (i + 1)
        for part in ("m", "v", "params"):
            assert got[part].keys() == after[part].keys()
            for n, t in got[part].items():
                g, w = _np(t), _np(after[part][n])
                assert t.dtype == after[part][n].dtype, (part, n)
                m, v = (_np(after[k][n]).astype(np.float64)
                        for k in ("m", "v"))
                dm, dv = _moment_gates(m, v, None if sum_gate is None
                                       else sum_gate[n])
                if part == "m":
                    gate = dm
                elif part == "v":
                    gate = dv
                else:
                    # the update lr m^ / (sqrt(v^) + eps), moved by dm, dv
                    root = np.sqrt(v / bc2)
                    gate = lr * (dm / bc1 / (root + 1e-8) + np.abs(m / bc1)
                                 * (dv / bc2) / (2 * np.maximum(root, 1e-30)
                                                 * (root + 1e-8) ** 2)) \
                        + np.spacing(np.abs(w))
                assert np.all(np.abs(g - w) <= gate), (i, part, n, float(
                    (np.abs(g - w) / np.maximum(gate, 1e-38)).max()))
        # a skipped update is off by all of the leaf's movement
        for n, t in got["params"].items():
            moved = np.abs(_np(after["params"][n])
                           - _np(before["params"][n])).sum()
            assert np.abs(_np(t) - _np(after["params"][n])).sum() <= \
                0.25 * moved, (i, n)


def test_state_from_reference_carries_every_bit():
    """grok-1's state: f32 params and bf16 moments, every leaf the
    reference's bits; a moment dtype other than the optimizer's is
    refused."""
    jcfg, tcfg, tree = _reference_params("grok-1-314b")
    jopt = jadamw(JAdamWConfig(moment_dtype=jnp.bfloat16))
    start = jax.tree.map(np.asarray, jts.create(
        jax.tree.map(jnp.asarray, tree), jopt))
    rng = np.random.default_rng(2)
    for key in ("m", "v"):
        start["opt"][key] = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape),
                                             jnp.bfloat16)), start["opt"][key])
    start["step"] = np.int32(7)
    opt = adamw(AdamWConfig(moment_dtype=torch.bfloat16))
    state = TT.state_from_reference(start, tcfg, opt, device="cpu")
    assert all(p.requires_grad for p in named(state["params"]).values())
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    for key in ("m", "v"):
        want = TT.flatten(TT._unstacked(start["opt"][key], tcfg,
                                        torch.device("cpu")))
        got = state["opt"][key]
        assert got.keys() == want.keys()
        for n, t in got.items():
            assert t.dtype == torch.bfloat16 and torch.equal(t, want[n])
    with pytest.raises(ValueError, match=r"opt.m.embed is .*bfloat16, the optimizer makes .*float32"):
        TT.state_from_reference(start, tcfg, adamw(AdamWConfig()),
                                device="cpu")


# --------------------------------------------------------------------------
# Cells and the launcher
# --------------------------------------------------------------------------

TRAIN_SPECS = {  # arch: (padded vocab, accumulation steps), the reference's
    "gemma2-2b": (256_000, 4),
    "qwen2.5-32b": (152_064, 16),
    "minicpm3-4b": (73_472, 4),
    "grok-1-314b": (131_072, 16),
    "phi3.5-moe-42b-a6.6b": (32_256, 4),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_builds_without_allocating(arch, monkeypatch):
    """``build_cell(arch, "train_4k")`` on the full config: the state's
    specs (params as ``param_specs``, m and v in the moment dtype, the
    router float32 unless the moments are bf16), the batch spec, the
    step's accumulation (grok-1 sums its 16 microbatches in bf16), and
    no parameter, state or tensor made on the way."""
    made, built = [], []
    for name in ("zeros", "empty", "full", "randn"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, **k: (
            made.append(a), _r(*a, **k))[1])
    make_step = steps.train_state.make_train_step
    monkeypatch.setattr(steps.train_state, "make_train_step",
                        lambda *a, **k: (built.append(k),
                                         make_step(*a, **k))[1])
    cell = steps.build_cell(arch, "train_4k", device="cpu")
    assert made == []
    cfg = tget(arch).make_config()
    rows, accum = TRAIN_SPECS[arch]
    state, bspec = cell.args
    assert (cell.kind, bspec) == ("train", {"tokens": ((256, 4097),
                                                       torch.int32)})
    assert state["params"] == TT.param_specs(cfg)
    assert state["params"]["embed"][0] == (cfg.padded_vocab, cfg.d_model)
    assert cfg.padded_vocab == rows
    mom = getattr(tget(arch), "MOMENT_DTYPE", None)
    for n, (shape, dt) in state["opt"]["m"].items():
        assert shape == state["params"][n][0]
        assert dt == (mom or state["params"][n][1])
    assert state["opt"]["m"] == state["opt"]["v"]
    assert state["step"] == ((), torch.int32)
    assert built == [{"accum_steps": accum, "accum_dtype": mom}]
    assert cfg.remat and not tget(arch).make_smoke_config().remat
    assert callable(cell.init_state)


def test_launcher_trains_gemma2_and_recovers(tmp_path, capsys):
    """``launch.train --arch gemma2-2b --steps 30 --fail-at 15 --device
    cpu``: returns 0 after one restart (from step 0: the first
    checkpoint would be at 25), the loss falls."""
    rc = launch_train.main(["--arch", "gemma2-2b", "--steps", "30",
                            "--fail-at", "15", "--device", "cpu",
                            "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    m = re.search(r"45 steps, 1 restarts, loss ([\d.]+) -> ([\d.]+)", out)
    assert m, out
    assert float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000025", "step_00000030"]


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_launcher_trains_every_lm(arch, capsys):
    assert launch_train.main(["--arch", arch, "--steps", "4", "--device",
                              "cpu"]) == 0
    assert re.search(rf"\[train\] {re.escape(arch)} on cpu: 4 steps, 0 "
                     r"restarts", capsys.readouterr().out)
