"""repro_torch's LM serving slice against the reference, with the
reference's weights carried across (``params_from_reference``): the
layers, ``forward``, ``forward_with_cache`` (prefill logits, every cache
leaf, decode steps), ``generate`` and the continuous-batching
``Engine`` on the smoke configs of the five LMs (GQA gemma2-2b and
qwen2.5-32b, MLA minicpm3-4b, MoE grok-1-314b and phi3.5-moe), plus the
configs, the cells and the entry points' device rule.

The reference initialises every norm weight and QKV bias to 0, which
leaves the logits of every model without gemma's ``1 +`` norms all
zero; the tests draw those leaves from a seeded normal instead, the
same numbers for both packages, so that every parameter takes part.

Tolerances: float32 layers 1e-5 and logits 1e-4 (sums in another order;
the port's prefill attention is the flash kernel's plain version, the
reference's the dense XLA path); bfloat16 logits 2e-2 of the largest
|logit| (the two round intermediate products at other places, and at
the smoke model's logits of magnitude ~4 one bfloat16 ulp is 0.031, so
an elementwise 2e-2 is below the dtype's resolution: the reference's
own bfloat16 logits are 0.057 from its float32 ones). Generated tokens:
equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.configs import lm_common as jlc
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch.configs import get_arch as tget
from repro_torch.kernels.flash_attention.ref import ulp_bf16 as fa_ulp
from repro_torch.configs import lm_common as tlc
from repro_torch.launch import steps
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

ARCHS = ("gemma2-2b", "qwen2.5-32b", "minicpm3-4b", "grok-1-314b",
         "phi3.5-moe-42b-a6.6b")
NEW_ARCHS = ARCHS[2:]
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
PERTURBED = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "bq", "bk",
             "bv", "q_norm", "kv_norm")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch: str, dtype: torch.dtype = torch.float32):
    j, t = jget(arch).make_smoke_config(), tget(arch).make_smoke_config()
    return (dataclasses.replace(j, dtype=JAX_DTYPE[dtype]),
            dataclasses.replace(t, dtype=dtype))


@functools.cache
def _models(arch: str, dtype: torch.dtype = torch.float32):
    """(reference config, reference params, port config, port params),
    the same values on both sides (shared by the tests, which only read
    them)."""
    jcfg, tcfg = _configs(arch, dtype)
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in paths:
        if getattr(path[-1], "key", None) in PERTURBED:
            leaf = rng.normal(0.0, 0.3, leaf.shape).astype(leaf.dtype)
        leaves.append(leaf)
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TT.params_from_reference(tree, tcfg, device="cpu"))


def _rand(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plus_one", (False, True))
def test_rms_norm_matches_reference(plus_one):
    x, w = _rand((3, 5, 32), 1), _rand((32,), 2)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                      plus_one)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_request", (False, True))
@pytest.mark.parametrize("theta", (10000.0, 1_000_000.0))
def test_apply_rope_matches_reference(per_request, theta):
    x = _rand((2, 6, 3, 16), 3)
    pos = np.array([0, 1, 5, 9, 100, 4095], np.int32)
    if per_request:
        pos = np.stack([pos, pos[::-1] + 7])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ("silu", "gelu"))
def test_gated_mlp_matches_reference(act):
    # weights at the model's scale, N(0, 1/fan_in)
    p = {"w_gate": _rand((32, 48), 4) / 32 ** 0.5,
         "w_up": _rand((32, 48), 5) / 32 ** 0.5,
         "w_down": _rand((48, 32), 6) / 48 ** 0.5}
    x = _rand((2, 7, 32), 7)
    want = JL.gated_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), act)
    got = TL.gated_mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), act)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 25.0),
                                        (8, 50.0)])
def test_attention_matches_reference_dense_and_blocked(window, cap):
    """Shared positions, the prefill case: the port's flash route (its
    plain version on the CPU) and its dense path against the
    reference's dense and blocked paths."""
    q, k, v = _rand((2, 40, 4, 16), 8), _rand((2, 40, 2, 16), 9), \
        _rand((2, 40, 2, 16), 10)
    pos = np.arange(40, dtype=np.int32)
    jkw = dict(q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
               window=window, attn_softcap=cap, scale=0.25, kv_mask=None)
    dense = JL._attention_dense(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **jkw)
    blocked = JL._attention_blocked(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_k=16, **jkw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tpos = torch.from_numpy(pos)
    routed = TL.multi_head_attention(tq, tk, tv, q_positions=tpos,
                                     k_positions=tpos, window=window,
                                     attn_softcap=cap, sm_scale=0.25)
    tdense = TL.attention_dense(tq, tk, tv, q_positions=tpos,
                                k_positions=tpos, window=window,
                                attn_softcap=cap, scale=0.25)
    for got in (routed, tdense):
        for want in (dense, blocked):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                       rtol=1e-5)


def test_decode_attention_matches_reference_dense():
    """Per-request positions over a cache with empty (-1) slots and a
    kv_mask, the decode case, through the dense path."""
    q, k, v = _rand((3, 1, 4, 16), 11), _rand((3, 24, 2, 16), 12), \
        _rand((3, 24, 2, 16), 13)
    qpos = np.array([[5], [17], [23]], np.int32)
    kpos = np.tile(np.arange(24, dtype=np.int32), (3, 1))
    kpos[0, 6:] = -1
    kpos[1, 3] = -1
    kvm = np.ones((3, 24), bool)
    kvm[2, :4] = False
    for window, mask in ((0, None), (8, None), (8, kvm)):
        want = JL._attention_dense(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
            window=window, attn_softcap=50.0, scale=0.25,
            kv_mask=None if mask is None else jnp.asarray(mask))
        got = TL.multi_head_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_positions=torch.from_numpy(qpos),
            k_positions=torch.from_numpy(kpos), window=window,
            attn_softcap=50.0, sm_scale=0.25,
            kv_mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)


def test_attention_routes_prefill_to_the_flash_kernel(monkeypatch):
    """Sq > 1 over fresh keys (k_positions IS q_positions) goes to the
    flash wrapper with causal=True and the layer's window and softcap;
    decode, and prefill-shaped calls over other keys, do not."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append(kw)
        return torch.zeros_like(q)

    monkeypatch.setattr(TL, "flash_attention", spy)
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    pos = torch.arange(8)
    TL.multi_head_attention(q, k, k, q_positions=pos, k_positions=pos,
                            window=4, attn_softcap=50.0)
    assert calls == [dict(sm_scale=0.25, causal=True, window=4,
                          softcap=50.0)]
    TL.multi_head_attention(q, k, k, q_positions=pos,
                            k_positions=torch.arange(8), window=4)
    TL.multi_head_attention(q[:, :1], k, k, q_positions=pos[None, :1],
                            k_positions=pos[None])
    TL.multi_head_attention(q, k, k, q_positions=pos, k_positions=pos,
                            kv_mask=torch.ones(1, 8, dtype=torch.bool))
    assert len(calls) == 1


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

def _reference_router_inputs(jparams, toks, jcfg):
    """The reference's logits and the bf16 token rows its MoE router saw,
    chunk by chunk in layer order (recorded by a debug callback)."""
    seen = []
    dispatch = JM._dispatch_chunk

    def record(params, xt, cfg, cap):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), xt,
                           ordered=True)
        return dispatch(params, xt, cfg, cap)

    JM._dispatch_chunk = record
    try:
        want, _ = JT.forward(jparams, jnp.asarray(toks), jcfg)
        jax.effects_barrier()
    finally:
        JM._dispatch_chunk = dispatch
    return want, seen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_forward_matches_reference(arch, dtype, tol, monkeypatch):
    """bfloat16 MoE: the two packages round the router's input at other
    sites (one bf16 ulp apart), which flips a top-2 choice where two
    experts' probabilities nearly tie (grok-1 smoke, layer 0: 0.28933 /
    0.28897; ROADMAP queue C); the port's router then takes the
    reference's bf16 router input, everything else its own, at the same
    tolerance. ``tests/test_torch_moe.py`` holds the routing itself
    equal on one input."""
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 19)).astype(
        np.int32)
    if tcfg.moe is not None and dtype == torch.bfloat16:
        want, seen = _reference_router_inputs(jparams, toks, jcfg)
        assert len(seen) == tcfg.n_layers
        inputs, route = iter(seen), TM.route
        monkeypatch.setattr(TM, "route", lambda p, xt, cfg, cap: route(
            p, TL.from_numpy(next(inputs)), cfg, cap))
    else:
        want, _ = JT.forward(jparams, jnp.asarray(toks), jcfg)
    got = TT.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    assert got.shape == (2, 19, tcfg.padded_vocab)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=tol,
                                   rtol=tol)
    else:   # normwise: one bf16 ulp at |logit| ~ 4 is already 0.031
        err = np.abs(got.numpy() - _np(want)).max()
        assert err <= tol * np.abs(_np(want)).max(), err


def test_bf16_moe_routing_differs_only_at_a_near_tie(monkeypatch):
    """Why the bf16 MoE forward above takes the reference's router
    input: each package's own bf16 forward of the grok-1 smoke config
    (phi3.5-moe's smoke config is the same) routes the same up to the
    first layer whose choices differ; there the two router inputs are
    within 2 bf16 ulps of each row's largest |value| (the packages
    round at other sites), and every row whose top-2 differs
    has two of its three largest probabilities within 2e-3: a near-tie
    that one rounding flips."""
    jcfg, jparams, tcfg, tparams = _models("grok-1-314b", torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 19)).astype(
        np.int32)
    _, seen = _reference_router_inputs(jparams, toks, jcfg)
    ours, route = [], TM.route

    def record(p, xt, cfg, cap):
        ours.append((xt.float().numpy(), p["router"]))
        return route(p, xt, cfg, cap)

    monkeypatch.setattr(TM, "route", record)
    TT.forward(tparams, torch.from_numpy(toks), tcfg)
    assert len(ours) == len(seen) == tcfg.n_layers
    for ref_x, (x, router) in zip(seen, ours):
        ref_x = ref_x.astype(np.float32)
        k = tcfg.moe.top_k
        probs = [np.asarray(jax.nn.softmax(jnp.asarray(a) @ jnp.asarray(
            router.numpy()), axis=-1)) for a in (ref_x, x)]
        idx = [np.asarray(jax.lax.top_k(jnp.asarray(p), k)[1])
               for p in probs]
        rows = np.nonzero((idx[0] != idx[1]).any(axis=1))[0]
        if rows.size == 0:
            continue
        ulp = fa_ulp(torch.from_numpy(np.abs(ref_x).max(axis=1))).numpy()
        assert (np.abs(ref_x - x).max(axis=1) <= 2 * ulp).all()
        top3 = -np.sort(-probs[0][rows], axis=1)[:, :k + 1]
        assert (np.diff(-top3, axis=1).min(axis=1) <= 2e-3).all(), top3
        break


def _ref_leaf(jcache, cfg, i: int, name: str):
    """Layer i's ``name`` leaf of the reference's stacked cache."""
    if cfg.layer_pattern == "local_global":
        half = "local" if i % 2 == 0 else "global"
        return jcache["layers"][half][name][i // 2]
    return jcache["layers"][name][i]


def _assert_caches_equal(tcache, jcache, cfg, atol):
    for key in ("pos", "pos_local"):
        assert (key in tcache) == (key in jcache)
        if key in tcache:
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(jcache[key]))
    for i, lc in enumerate(tcache["layers"]):
        for name, t in lc.items():
            np.testing.assert_allclose(_np(t), _np(_ref_leaf(jcache, cfg, i,
                                                             name)),
                                       atol=atol, rtol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_cache_prefill_and_decode_match_reference(arch):
    """Right-padded prompts shorter and longer than the smoke window (8):
    prefill logits and every cache leaf, then three decode steps."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    P, buf = 20, 28
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (3, P)).astype(
        np.int32)
    lens = np.array([5, 13, 20], np.int32)
    jc = JT.init_cache(jcfg, 3, buf)
    tc = TT.init_cache(tcfg, 3, buf, device="cpu")
    jl, jc = JT.forward_with_cache(jparams, jnp.asarray(toks), jcfg, jc,
                                   jnp.arange(P, dtype=jnp.int32),
                                   valid_len=jnp.asarray(lens))
    tl, tc = TT.forward_with_cache(tparams, torch.from_numpy(toks), tcfg, tc,
                                   torch.arange(P, dtype=torch.int32),
                                   valid_len=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_caches_equal(tc, jc, tcfg, 1e-5)
    pos = lens.copy()
    nxt = toks[np.arange(3), lens - 1]
    for _ in range(3):
        jl, jc = JT.forward_with_cache(jparams, jnp.asarray(nxt)[:, None],
                                       jcfg, jc, jnp.asarray(pos)[:, None])
        tl, tc = TT.forward_with_cache(tparams, torch.from_numpy(nxt)[:, None],
                                       tcfg, tc,
                                       torch.from_numpy(pos)[:, None])
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4,
                                   rtol=1e-4)
        _assert_caches_equal(tc, jc, tcfg, 1e-5)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
        pos += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    S = 14
    toks = np.random.default_rng(3).integers(1, tcfg.vocab, (3, S)).astype(
        np.int32)
    lens = np.array([4, 11, 14])
    prompts = np.where(np.arange(S)[None] < lens[:, None], toks, -1)
    want = JE.generate(jparams, jcfg, prompts, max_new=6, cache_buf=S + 8)
    got = TE.generate(tparams, tcfg, prompts, max_new=6, cache_buf=S + 8)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_reference(arch):
    """Five requests through two slots (three admitted mid-flight),
    prompts 3-14 tokens against a window of 8 and a 16-token buffer."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    outs = []
    for mod, params, cfg in ((JE, jparams, jcfg), (TE, tparams, tcfg)):
        eng = mod.Engine(params, cfg, slots=2, prompt_buf=16, cache_buf=40)
        rng = np.random.default_rng(4)
        for _ in range(5):
            eng.submit(rng.integers(1, cfg.vocab, int(rng.integers(3, 15))),
                       max_new=int(rng.integers(3, 8)))
        done = eng.run()
        outs.append([(r.uid, r.out_tokens) for r in done])
    assert len(outs[1]) == 5
    assert outs[1] == outs[0]


def test_sample_top_p():
    logits = torch.from_numpy(_rand((4, 300), 5) * 3)
    for p in (0.0, 1e-9):
        got = TE.sample_top_p(logits, torch.Generator().manual_seed(0), p=p)
        assert torch.equal(got, TE.greedy(logits))
    draws = [TE.sample_top_p(logits, torch.Generator().manual_seed(9), p=0.9)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    # every draw lies in the nucleus: the top tokens holding mass 0.9
    probs = torch.softmax(logits, -1)
    for _ in range(20):
        tok = TE.sample_top_p(logits, torch.Generator().manual_seed(_), p=0.9)
        above = (probs > probs.gather(-1, tok[:, None].long())).float()
        assert bool(((probs * above).sum(-1) <= 0.9 + 1e-6).all())


# --------------------------------------------------------------------------
# Configs, parameters, cells, devices
# --------------------------------------------------------------------------

CONFIG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "head_dim", "d_ff", "vocab", "qkv_bias", "rope_theta",
                 "norm_eps", "attn_softcap", "final_softcap", "window",
                 "layer_pattern", "attention", "post_norm", "embed_scale",
                 "tie_embed", "act", "remat", "padded_vocab", "q_dim",
                 "o_in_dim")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("make", ("make_config", "make_smoke_config"))
def test_configs_field_equal(arch, make):
    j, t = getattr(jget(arch), make)(), getattr(tget(arch), make)()
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    for f in ("mla", "moe"):
        sub_t, sub_j = getattr(t, f), getattr(j, f)
        assert (sub_t is None) == (sub_j is None), f
        if sub_t is not None:
            assert dataclasses.asdict(sub_t) == dataclasses.asdict(sub_j), f
    assert JAX_DTYPE[t.dtype] == j.dtype
    assert TT.param_count(t) == JT.param_count(j)
    mod, ref = tget(arch), jget(arch)
    assert (mod.ARCH_ID, mod.FAMILY, mod.SHAPES) == (ref.ARCH_ID, ref.FAMILY,
                                                     ref.SHAPES)
    for shape in mod.SHAPES:
        assert mod.step_kind(shape) == ref.step_kind(shape)
        assert mod.skip_reason(shape) == ref.skip_reason(shape)


def test_unported_lm_configs_raise():
    """What an LM cell refuses: the GNN ids resolve (``get_arch``) and
    build their own shapes' cells, but not an LM shape (``train_4k`` is
    no GNN shape). Every LM's train cell builds (LM training is
    ported); an MLA config without its ``MLAConfig`` is refused."""
    for arch in ("nequip", "gatedgcn", "graphsage-reddit", "gin-tu"):
        assert tget(arch).FAMILY == "gnn"
        with pytest.raises(KeyError, match="train_4k"):
            steps.build_cell(arch, "train_4k", device="cpu")
        assert steps.build_cell(arch, "molecule",
                                device="cpu").kind == "train"
    for arch in ARCHS:
        assert steps.build_cell(arch, "train_4k",
                                device="cpu").kind == "train"
    with pytest.raises(ValueError, match="MLAConfig"):
        TT.LMConfig(name="x", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
                    head_dim=4, d_ff=8, vocab=16, attention="mla")


def _spec_tree(struct):
    """The reference's ShapeDtypeStruct tree as (shape, torch dtype)."""
    dt = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
    return jax.tree.map(lambda s: (tuple(s.shape), dt[jnp.dtype(s.dtype)]),
                        struct)


@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k", "long_500k",
                                   "train_4k"))
def test_input_specs_match_reference(shape):
    cfg = tget("gemma2-2b").make_config()
    got = tlc.input_specs(shape, cfg)
    want = _spec_tree(jlc.input_specs(shape, jget("gemma2-2b").make_config()))
    assert got.keys() == want.keys()
    for k in got:
        if k != "cache":
            assert got[k] == want[k]
            continue
        for key in ("pos", "pos_local"):
            assert got[k][key] == want[k][key]
        n_stack = cfg.n_layers // 2
        for i, lc in enumerate(got[k]["layers"]):
            half = want[k]["layers"]["local" if i % 2 == 0 else "global"]
            for name, (s, dt) in lc.items():
                assert (n_stack, *s) == half[name][0] and dt == half[name][1]


@pytest.mark.parametrize("shape,kind,extra", [
    ("prefill_32k", "prefill", ()), ("decode_32k", "decode", ("positions",)),
    ("long_500k", "decode", ("positions",))])
def test_build_cell_kinds_and_specs(shape, kind, extra):
    cell = steps.build_cell("gemma2-2b", shape, device="cpu")
    assert (cell.arch, cell.shape, cell.kind) == ("gemma2-2b", shape, kind)
    cfg = tget("gemma2-2b").make_config()
    specs = tlc.input_specs(shape, cfg)
    params = cell.args[0]
    assert params["embed"] == ((256_000, 2304), torch.bfloat16)
    assert params["layers.25.mlp.w_down"] == ((9216, 2304), torch.bfloat16)
    assert "lm_head" not in params and len(params) == 2 + 26 * 11
    assert cell.args[1:] == (specs["tokens"],
                             *(specs[e] for e in extra), specs["cache"])


def test_cell_steps_run_the_model(monkeypatch):
    """The prefill and decode steps, built for the smoke config, take
    host tokens and give the reference's logits."""
    jcfg, jparams, tcfg, tparams = _models("gemma2-2b")
    monkeypatch.setattr(tget("gemma2-2b"), "make_config", lambda: tcfg)
    prefill = steps.build_cell("gemma2-2b", "prefill_32k", device="cpu")
    decode = steps.build_cell("gemma2-2b", "decode_32k", device="cpu")
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 12)).astype(
        np.int32)
    tl, tc = prefill.step(tparams, toks,
                          TT.init_cache(tcfg, 2, 16, device="cpu"))
    jl, jc = JT.forward_with_cache(jparams, jnp.asarray(toks), jcfg,
                                   JT.init_cache(jcfg, 2, 16),
                                   jnp.arange(12, dtype=jnp.int32))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    nxt, pos = toks[:, -1], np.array([12, 12], np.int32)
    tl, tc = decode.step(tparams, nxt, pos, tc)
    jl, jc = JT.forward_with_cache(jparams, jnp.asarray(nxt)[:, None], jcfg,
                                   jc, jnp.asarray(pos)[:, None])
    assert tl.shape == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)


def test_params_from_reference_checks_dtype_and_layout():
    jcfg, tcfg = _configs("gemma2-2b")
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="bfloat16"):
        TT.params_from_reference(
            tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
            device="cpu")
    got = TT.params_from_reference(tree, tcfg, device="cpu")
    np.testing.assert_array_equal(
        got["layers"][2]["attn"]["wq"].numpy(),
        tree["blocks"]["local"]["attn"]["wq"][1])
    np.testing.assert_array_equal(
        got["layers"][3]["mlp"]["w_up"].numpy(),
        tree["blocks"]["global"]["mlp"]["w_up"][1])


def test_init_shapes_and_determinism():
    cfg = tget("qwen2.5-32b").make_smoke_config()
    a = TT.init(cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    b = TT.init(cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    fa, fb = TT.flatten(a), TT.flatten(b)
    assert {k: tuple(v.shape) for k, v in fa.items()} == \
        TT.flatten(TT.param_shapes(cfg))
    for k, v in fa.items():
        assert v.dtype == cfg.dtype and torch.equal(v, fb[k]), k
    assert float(fa["layers.0.attn.wq"].std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)
    assert float(fa["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_lm_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("gemma2-2b").make_smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("gemma2-2b", "prefill_32k")
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0),
                                            _configs("gemma2-2b")[0]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.params_from_reference(tree, cfg, device=None)


def test_lm_train_cell_raises(monkeypatch):
    """The LM train cell (ported) raises where it must: without CUDA
    unless given ``device="cpu"``, over parameters that do not require
    grad, and on a batch that does not split into its 4 microbatches."""
    jcfg, jparams, tcfg, tparams = _models("gemma2-2b")
    monkeypatch.setattr(tget("gemma2-2b"), "make_config", lambda: tcfg)
    cell = steps.build_cell("gemma2-2b", "train_4k", device="cpu")
    with pytest.raises(ValueError, match="do not require grad"):
        cell.init_state(tparams)
    tree = jax.tree.map(np.asarray, jparams)
    state = cell.init_state(TT.params_from_reference(
        tree, tcfg, device="cpu", requires_grad=True))
    toks = np.zeros((6, 9), np.int32)
    with pytest.raises(ValueError, match="does not split into 4"):
        cell.step(state, {"tokens": toks})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("gemma2-2b", "train_4k")


# --------------------------------------------------------------------------
# MLA (minicpm3-4b) and the MoE archs: attention route, parts, specs, cells
# --------------------------------------------------------------------------

FULL_PARAM_COUNTS = {"minicpm3-4b": 4_262_025_728,
                     "phi3.5-moe-42b-a6.6b": 41_874_100_224,
                     "grok-1-314b": 316_489_340_928}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_param_count_equals_reference(arch):
    """The full configs' counts, the reference's from ``jax.eval_shape``
    (nothing allocated on either side)."""
    want = FULL_PARAM_COUNTS[arch]
    assert JT.param_count(jget(arch).make_config()) == want
    assert TT.param_count(tget(arch).make_config()) == want


def test_mla_prefill_reaches_the_flash_kernel_padded(monkeypatch):
    """The smoke MLA prefill (q / k head dim 24, v 16) goes to the flash
    wrapper zero-padded to d = 32 with the scale of d = 24, once per
    layer, never to ``attention_dense``; its decode goes to the dense
    path."""
    _, _, tcfg, tparams = _models("minicpm3-4b")
    calls = []
    flash = TL.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], kw))
        return flash(q, k, v, **kw)

    def no_dense(*a, **kw):
        raise AssertionError("MLA prefill reached attention_dense")

    monkeypatch.setattr(TL, "flash_attention", spy)
    monkeypatch.setattr(TL, "attention_dense", no_dense)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, 10)).astype(np.int32))
    cache = TT.init_cache(tcfg, 2, 16, device="cpu")
    TT.forward_with_cache(tparams, toks, tcfg, cache,
                          torch.arange(10, dtype=torch.int32))
    assert [c[:3] for c in calls] == [(32, 32, 32)] * tcfg.n_layers
    assert all(c[3] == dict(sm_scale=24 ** -0.5, causal=True, window=0,
                            softcap=0.0) for c in calls)
    with pytest.raises(AssertionError, match="attention_dense"):
        TT.forward_with_cache(tparams, toks[:, :1], tcfg, cache,
                              torch.full((2, 1), 10, dtype=torch.int32))


@pytest.mark.parametrize("d,dv,hkv", [(24, 16, 4), (96, 64, 2), (64, 64, 2),
                                      (40, 40, 4)])
def test_padded_flash_route_equals_dense_on_unpadded(d, dv, hkv):
    """Head dims the kernel does not take (MLA's 96 / 64, the smoke
    24 / 16, equal dims off the list) through the padded flash route
    equal ``attention_dense`` on the unpadded tensors within f32 1e-6."""
    q = torch.from_numpy(_rand((2, 33, 4, d), 20))
    k = torch.from_numpy(_rand((2, 33, hkv, d), 21))
    v = torch.from_numpy(_rand((2, 33, hkv, dv), 22))
    pos = torch.arange(33, dtype=torch.int32)
    got = TL.multi_head_attention(q, k, v, q_positions=pos, k_positions=pos,
                                  sm_scale=d ** -0.5)
    want = TL.attention_dense(q, k, v, q_positions=pos, k_positions=pos,
                              window=0, attn_softcap=0.0, scale=d ** -0.5)
    assert got.shape == (2, 33, 4, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def _mla_inputs(seed: int):
    jcfg, jparams, tcfg, tparams = _models("minicpm3-4b")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    return jcfg, jp, tcfg, tparams["layers"][0]["attn"], _rand(
        (2, 12, tcfg.d_model), seed)


def test_mla_project_and_prefill_attention_match_reference():
    jcfg, jp, tcfg, tp, x = _mla_inputs(30)
    pos = np.arange(12, dtype=np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for want, got in zip(JT._mla_project(jp, jcfg, jx, jnp.asarray(pos)),
                         TT._mla_project(tp, tcfg, tx, torch.from_numpy(pos))):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    want = JT._mla_attention(jp, jcfg, jx, jnp.asarray(pos))
    got = TT._mla_attention(tp, tcfg, tx, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_mla_decode_attention_over_a_cache_matches_reference():
    """One query a request at per-request positions over a latent cache
    of 12 slots with empty (-1) ones."""
    jcfg, jp, tcfg, tp, x = _mla_inputs(31)
    cpos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    cpos[0, 7:] = -1
    ckv, kr = JT._mla_project(jp, jcfg, jnp.asarray(x), jnp.asarray(cpos))
    q_in = _rand((2, 1, tcfg.d_model), 32)
    qpos = np.array([[6], [11]], np.int32)
    want = JT._mla_attention(jp, jcfg, jnp.asarray(q_in), jnp.asarray(qpos),
                             cache_override=(ckv, kr),
                             k_positions=jnp.asarray(cpos))
    got = TT._mla_attention(tp, tcfg, torch.from_numpy(q_in),
                            torch.from_numpy(qpos),
                            cache_override=(TL.from_numpy(ckv),
                                            TL.from_numpy(kr)),
                            k_positions=torch.from_numpy(cpos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k", "long_500k",
                                   "train_4k"))
def test_new_arch_input_specs_match_reference(arch, shape):
    """The MLA cache (``ckv``, ``kr``) and the GQA caches of the MoE
    archs, layer by layer against the reference's stacked
    ``cache_struct``."""
    got = tget(arch).input_specs(shape)
    want = _spec_tree(jget(arch).input_specs(shape))
    assert got.keys() == want.keys()
    for k in got:
        if k != "cache":
            assert got[k] == want[k]
            continue
        assert got[k].keys() == want[k].keys()
        assert got[k]["pos"] == want[k]["pos"]
        n = tget(arch).make_config().n_layers
        assert len(got[k]["layers"]) == n
        for lc in got[k]["layers"]:
            assert lc.keys() == want[k]["layers"].keys()
            for name, (s, dt) in lc.items():
                assert ((n, *s), dt) == want[k]["layers"][name]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_cells_build_with_float32_router(arch):
    """Prefill, decode and long_500k cells build on the CPU (allocating
    nothing); every parameter spec carries bf16 but the MoE router,
    float32; long_500k is skipped with the reference's reason."""
    cfg = tget(arch).make_config()
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        cell = steps.build_cell(arch, shape, device="cpu")
        assert cell.kind == tget(arch).step_kind(shape)
        params = cell.args[0]
        assert params == TT.param_specs(cfg)
        for name, (_, dt) in params.items():
            assert dt == (torch.float32 if name.endswith("moe.router")
                          else torch.bfloat16), name
    assert tget(arch).skip_reason("long_500k") == \
        jget(arch).skip_reason("long_500k") is not None
    if cfg.moe is not None:
        assert params["layers.0.moe.w_gate"][0] == (
            cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    else:
        assert params["layers.0.attn.kv_b"][0] == (256, 40 * 128)


def test_params_from_reference_keeps_the_float32_router():
    jcfg, jparams, tcfg, tparams = _models("grok-1-314b")
    tree = jax.tree.map(np.asarray, jparams)
    assert tparams["layers"][1]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tparams["layers"][1]["moe"]["w_down"],
                                  tree["blocks"]["moe"]["w_down"][1])
    jb, tb = _configs("grok-1-314b", torch.bfloat16)
    btree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jb))
    got = TT.params_from_reference(btree, tb, device="cpu")
    assert got["layers"][0]["moe"]["router"].dtype == torch.float32
    assert got["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16
    btree["blocks"]["moe"]["router"] = btree["blocks"]["moe"][
        "router"].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="router"):
        TT.params_from_reference(btree, tb, device="cpu")
