"""The LM transformer, the port of ``repro.models.transformer``:
grouped-query attention (GQA) with gemma2's features (alternating local
sliding-window and global layers, logit softcaps, post-norms, embedding
scaling, tied embeddings, GeGLU) and qwen2.5's (QKV bias, SwiGLU);
multi-head latent attention (MLA: low-rank Q and KV with a decoupled
rotary part, minicpm3); and the MoE FFN (``models.moe``: grok-1,
phi3.5-moe).

Parameters are plain dicts of tensors: ``embed`` [padded_vocab, D],
``layers`` (one dict per layer, in order), ``final_norm`` and, unless
the embedding is tied, ``lm_head``. Every leaf carries the config's
dtype except the MoE router, which is float32 (``param_specs``). The
reference stacks its layers and ``lax.scan``s them, with a (local,
global) pair as the scan unit; here the layers are a list walked by a
loop, layer 2i being block i's ``local`` half and 2i + 1 its ``global``
half (``params_from_reference`` does the unstacking).

Serving (``forward_with_cache``): requests are RIGHT-padded to the
prompt buffer; every position's cache slot is its index (full caches)
or index % W (the ring caches of gemma2's local layers). Prefill
attends with the fresh keys, through the flash-attention kernel, and
only WRITES the cache; decode reads the cache through its stored
per-slot positions (-1 = empty), through the dense path. Unlike the
reference, the cache is updated IN PLACE and returned. An MLA layer
caches its normed latent ``ckv`` and roped ``kr`` and re-expands k and
v from them at every decode step (the reference's cache-lean variant).

Training (``loss_fn``): next-token cross-entropy through
``layers.chunked_lm_loss`` plus the MoE load-balancing aux loss summed
over the layers. With ``cfg.remat`` and grad on, each block (a
(local, global) pair, else a layer) runs under ``checkpoint``, as the
reference's scanned block runs under ``jax.checkpoint``; prefill-shaped
attention takes the flash kernel's autograd wrapper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.graphs.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_apply, moe_params


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0                   # sliding window width (local layers)
    layer_pattern: str = "global"     # "global" | "local_global"
    attention: str = "gqa"            # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    post_norm: bool = False           # gemma2-style post-norms
    embed_scale: bool = False         # multiply embedding by sqrt(D)
    tie_embed: bool = False           # lm_head = embed.T (gemma2)
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                # recompute each block in backward

    def __post_init__(self):
        if self.attention not in ("gqa", "mla"):
            raise ValueError(f"unknown attention {self.attention!r}")
        if (self.attention == "mla") != (self.mla is not None):
            raise ValueError("attention='mla' goes with an MLAConfig")
        if self.layer_pattern not in ("global", "local_global"):
            raise ValueError(f"unknown layer_pattern {self.layer_pattern!r}")
        if self.layer_pattern == "local_global" and self.n_layers % 2:
            raise ValueError("local_global needs an even layer count")

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a multiple of 256, as the
        reference pads them; the padded rows are initialised too and
        take part in every argmax."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            return self.n_heads * (self.mla.qk_nope_dim
                                   + self.mla.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def o_in_dim(self) -> int:
        if self.attention == "mla":
            return self.n_heads * self.mla.v_head_dim
        return self.n_heads * self.head_dim

    def is_local(self, layer: int) -> bool:
        """Whether ``layer`` is a local (ring-cached) layer."""
        return self.layer_pattern == "local_global" and layer % 2 == 0

    def layer_window(self, layer: int) -> int:
        """The sliding window of ``layer`` (0 = full attention)."""
        if self.layer_pattern == "local_global":
            return self.window if layer % 2 == 0 else 0
        return self.window


# ==========================================================================
# Parameters
# ==========================================================================

def _attn_shapes(cfg: LMConfig) -> dict:
    d = cfg.d_model
    if cfg.attention == "mla":
        m = cfg.mla
        return {"q_a": (d, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
                "q_b": (m.q_lora_rank, cfg.q_dim),
                "kv_a": (d, m.kv_lora_rank + m.qk_rope_dim),
                "kv_norm": (m.kv_lora_rank,),
                "kv_b": (m.kv_lora_rank,
                         cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)),
                "wo": (cfg.o_in_dim, d)}
    kv = cfg.n_kv_heads * cfg.head_dim
    attn = {"wq": (d, cfg.q_dim), "wk": (d, kv), "wv": (d, kv),
            "wo": (cfg.q_dim, d)}
    if cfg.qkv_bias:
        attn.update(bq=(cfg.q_dim,), bk=(kv,), bv=(kv,))
    return attn


def _layer_shapes(cfg: LMConfig) -> dict:
    d = cfg.d_model
    p = {"ln1": (d,), "ln2": (d,), "attn": _attn_shapes(cfg)}
    if cfg.moe is not None:
        e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        p["moe"] = {"router": (d, e), "w_gate": (e, d, f),
                    "w_up": (e, d, f), "w_down": (e, f, d)}
    else:
        p["mlp"] = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                    "w_down": (cfg.d_ff, d)}
    if cfg.post_norm:
        p.update(ln1_post=(d,), ln2_post=(d,))
    return p


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree with a shape at each leaf (allocates
    nothing)."""
    out = {"embed": (cfg.padded_vocab, cfg.d_model),
           "layers": [_layer_shapes(cfg) for _ in range(cfg.n_layers)],
           "final_norm": (cfg.d_model,)}
    if not cfg.tie_embed:
        out["lm_head"] = (cfg.d_model, cfg.padded_vocab)
    return out


def flatten(tree, prefix: str = "") -> dict:
    """``{dotted name: leaf}`` of a parameter or cache tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def param_specs(cfg: LMConfig) -> dict:
    """``{dotted name: (shape, dtype)}`` of every parameter: the config's
    dtype, float32 for the MoE router (allocates nothing)."""
    return {n: (s, torch.float32 if n.endswith("moe.router") else cfg.dtype)
            for n, s in flatten(param_shapes(cfg)).items()}


def param_count(cfg: LMConfig) -> int:
    return sum(math.prod(s) for s in flatten(param_shapes(cfg)).values())


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW's weight decay applies to parameter ``name``, as it
    does in the reference: there every layer's leaf is stacked
    [n_stack, ...] and so a matrix, which the reference's rule
    (``ndim >= 2``) decays, norm weights and biases included; of the
    rest, the matrices (``train.optimizer.AdamWConfig.decays``)."""
    return name.startswith("layers.") or p.dim() >= 2


def _trainable(params: dict, requires_grad: bool) -> dict:
    if requires_grad:
        for t in flatten(params).values():
            t.requires_grad_(True)
    return params


def init(cfg: LMConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> dict:
    """Random parameters on ``device`` (CUDA unless given; raises
    without CUDA unless ``device="cpu"``) with the reference's
    initialisation: embedding N(0, 0.02²), projections, the MoE router
    (float32) and experts N(0, 1/fan_in), biases and norm weights 0.
    Every draw comes from ``generator`` (a generator of that device
    seeded 0 when None). ``requires_grad`` makes every leaf trainable
    (``train.train_state.create`` takes only such parameters)."""
    dev = resolve_device(device)
    if generator is None:
        generator = L.seeded_generator(dev)
    g = {"generator": generator, "device": dev}
    d = cfg.d_model
    zeros = lambda *s: torch.zeros(s, dtype=cfg.dtype, device=dev)

    def attn():
        shapes = _attn_shapes(cfg)
        return {name: zeros(*s) if len(s) == 1 else
                L.normal_init(s, s[0] ** -0.5, cfg.dtype, **g)
                for name, s in shapes.items()}

    def layer():
        p = {"ln1": zeros(d), "ln2": zeros(d), "attn": attn()}
        if cfg.moe is not None:
            p["moe"] = moe_params(d, cfg.moe, cfg.dtype, **g)
        else:
            p["mlp"] = L.gated_mlp_params(d, cfg.d_ff, cfg.dtype, **g)
        if cfg.post_norm:
            p.update(ln1_post=zeros(d), ln2_post=zeros(d))
        return p

    out = {"embed": L.normal_init((cfg.padded_vocab, d), 0.02, cfg.dtype,
                                  **g),
           "layers": [layer() for _ in range(cfg.n_layers)],
           "final_norm": zeros(d)}
    if not cfg.tie_embed:
        out["lm_head"] = L.normal_init((d, cfg.padded_vocab), d ** -0.5,
                                       cfg.dtype, **g)
    return _trainable(out, requires_grad)


def _unstacked(tree: dict, cfg: LMConfig, dev: torch.device) -> dict:
    """A tree of the reference's layout (``blocks`` stacked) in the
    port's (``layers``, a list), its host arrays moved to ``dev``."""
    def conv(a):
        return L.from_numpy(a).to(dev)

    def unstack(blocks, i):
        if isinstance(blocks, dict):
            return {k: unstack(v, i) for k, v in blocks.items()}
        return conv(blocks[i])

    if cfg.layer_pattern == "local_global":
        layers = []
        for i in range(cfg.n_layers // 2):
            layers += [unstack(tree["blocks"]["local"], i),
                       unstack(tree["blocks"]["global"], i)]
    else:
        layers = [unstack(tree["blocks"], i) for i in range(cfg.n_layers)]
    out = {"embed": conv(tree["embed"]), "layers": layers,
           "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    return out


def params_from_reference(tree: dict, cfg: LMConfig, *, device,
                          requires_grad: bool = False) -> dict:
    """The port's parameters holding exactly the values of the
    reference's tree (``embed``, ``blocks`` stacked [n_stack, ...],
    ``final_norm``, ``lm_head``) given as host arrays. For
    ``local_global`` block i's ``local`` half becomes layer 2i and its
    ``global`` half layer 2i + 1. Raises if a shape or dtype differs
    from ``param_specs(cfg)``'s (the MoE router float32, the rest the
    config's dtype). ``requires_grad`` as in ``init``."""
    out = _unstacked(tree, cfg, resolve_device(device))
    got, want = flatten(out), param_specs(cfg)
    if {k: tuple(v.shape) for k, v in got.items()} != \
            {k: s for k, (s, _) in want.items()}:
        raise ValueError("parameter shapes do not match the config")
    for name, t in got.items():
        if t.dtype != want[name][1]:
            raise ValueError(f"{name} is {t.dtype}, the config says "
                             f"{want[name][1]}")
    return _trainable(out, requires_grad)


def state_from_reference(tree: dict, cfg: LMConfig, opt, *, device) -> dict:
    """A port TrainState (``train.train_state``) holding exactly the
    values of a reference TrainState given as host arrays: ``params``
    (trainable, unstacked as in ``params_from_reference``), the
    optimizer ``opt``'s moment trees under ``opt`` (each in the
    reference's stacked layout, unstacked alike and keyed by parameter
    name) and ``step`` (int32). Raises if a moment's shape or dtype
    differs from what ``opt`` makes for these parameters (AdamW's
    ``moment_dtype``)."""
    from repro_torch.train import train_state
    from repro_torch.train.optimizer import named

    dev = resolve_device(device)
    state = train_state.create(
        params_from_reference(tree["params"], cfg, device=dev,
                              requires_grad=True), opt)
    if set(tree["opt"]) != set(state["opt"]):
        raise ValueError(f"optimizer state {sorted(tree['opt'])}, the "
                         f"optimizer makes {sorted(state['opt'])}")
    for key, want in state["opt"].items():
        got = named(_unstacked(tree["opt"][key], cfg, dev))
        for name, t in want.items():
            if got[name].shape != t.shape or got[name].dtype != t.dtype:
                raise ValueError(
                    f"opt.{key}.{name} is {tuple(got[name].shape)} "
                    f"{got[name].dtype}, the optimizer makes "
                    f"{tuple(t.shape)} {t.dtype}")
        state["opt"][key] = {name: got[name] for name in want}
    state["step"].fill_(int(tree["step"]))
    return state


# ==========================================================================
# Forward pass
# ==========================================================================

def _gqa_project_kv(p: dict, cfg: LMConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """x [B, S, D] -> roped k, v [B, S, Hkv, dh]."""
    b, s, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return L.apply_rope(k, positions, cfg.rope_theta), v


def _gqa_attention(p: dict, cfg: LMConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: int, kv_override=None,
                   k_positions=None) -> torch.Tensor:
    """x [B, S, D]. ``kv_override``: (k, v), already roped, from the
    caller (a prefill's fresh keys or a decode cache); ``positions`` may
    be [S] or per-request [B, S]."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = L.apply_rope(q.reshape(b, s, cfg.n_heads, cfg.head_dim), positions,
                     cfg.rope_theta)
    if kv_override is None:
        k, v = _gqa_project_kv(p, cfg, x, positions)
        k_positions = positions
    else:
        k, v = kv_override
    out = L.multi_head_attention(
        q, k, v, q_positions=positions, k_positions=k_positions,
        window=window, attn_softcap=cfg.attn_softcap)
    return out.reshape(b, s, cfg.q_dim) @ p["wo"]


def _mla_project(p: dict, cfg: LMConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x [B, S, D] -> (the normed latent ckv [B, S, kv_lora_rank], the
    roped k_rope [B, S, qk_rope_dim]): what the MLA decode cache
    holds."""
    m = cfg.mla
    ckv, k_rope = (x @ p["kv_a"]).split([m.kv_lora_rank, m.qk_rope_dim],
                                        dim=-1)
    ckv = L.rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_attention(p: dict, cfg: LMConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache_override=None,
                   k_positions=None) -> torch.Tensor:
    """MLA: low-rank compressed q and kv with a decoupled rotary part
    (DeepSeek-V2 style). ``cache_override``: (ckv, k_rope), already
    normed and roped (a prefill's fresh latent or a decode cache); k and
    v are re-expanded from the latent at every call (the cache-lean
    variant). q and k have head dim qk_nope + qk_rope, v v_head_dim."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = L.rms_norm(x @ p["q_a"], p["q_norm"], cfg.norm_eps)
    q_nope, q_rope = (cq @ p["q_b"]).reshape(
        b, s, h, m.qk_nope_dim + m.qk_rope_dim).split(
            [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q = torch.cat([q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    if cache_override is None:
        ckv, k_rope = _mla_project(p, cfg, x, positions)
        k_positions = positions
    else:
        ckv, k_rope = cache_override
    k_nope, v = (ckv @ p["kv_b"]).reshape(
        ckv.shape[0], ckv.shape[1], h, m.qk_nope_dim + m.v_head_dim).split(
            [m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_dim)], dim=-1)
    out = L.multi_head_attention(
        q, k, v, q_positions=positions, k_positions=k_positions, window=0,
        attn_softcap=cfg.attn_softcap,
        sm_scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5)
    return out.reshape(b, s, cfg.o_in_dim) @ p["wo"]


def _ffn_block(p: dict, cfg: LMConfig, x: torch.Tensor, a: torch.Tensor):
    """The residual around the attention output ``a``, then the FFN's.
    Returns (x, the MoE's load-balancing aux loss, float32; None without
    MoE); the serving path drops the aux loss, as the reference's
    does."""
    if cfg.post_norm:
        a = L.rms_norm(a, p["ln1_post"], cfg.norm_eps, plus_one=True)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=cfg.post_norm)
    if cfg.moe is not None:
        f, aux = moe_apply(p["moe"], h, cfg.moe)
    else:
        f, aux = L.gated_mlp_apply(p["mlp"], h, cfg.act), None
    if cfg.post_norm:
        f = L.rms_norm(f, p["ln2_post"], cfg.norm_eps, plus_one=True)
    return x + f, aux


def _layer_apply(p: dict, cfg: LMConfig, x: torch.Tensor,
                 positions: torch.Tensor, window: int):
    """One layer; returns (x, its aux loss or None)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norm)
    if cfg.attention == "mla":
        a = _mla_attention(p["attn"], cfg, h, positions)
    else:
        a = _gqa_attention(p["attn"], cfg, h, positions, window)
    return _ffn_block(p, cfg, x, a)


def _block_apply(layers: list, cfg: LMConfig, x: torch.Tensor,
                 positions: torch.Tensor, first: int):
    """The reference's scan unit, layers ``first``.. (a (local, global)
    pair, or one layer); returns (x, the summed aux loss or None)."""
    aux = None
    for j, lp in enumerate(layers):
        x, a = _layer_apply(lp, cfg, x, positions,
                            cfg.layer_window(first + j))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params: dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embed else params["lm_head"]


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Final norm, head product in the model dtype, then float32 and
    the final softcap (in place on the fresh float32 logits)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps,
                   plus_one=cfg.post_norm)
    logits = (x @ _head(params, cfg)).float()
    if cfg.final_softcap > 0.0:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
                   with_aux: bool = False):
    """tokens [B, S] -> hidden states [B, S, D] before the final norm;
    with ``with_aux``, (those, the MoE aux loss summed over the layers,
    float32). With ``cfg.remat`` and grad on, each block (a (local,
    global) pair, else a layer) runs under ``checkpoint``: the backward
    keeps only the blocks' inputs and recomputes each block."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    layers = params["layers"]
    unit = 2 if cfg.layer_pattern == "local_global" else 1
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, len(layers), unit):
        args = (layers[i:i + unit], cfg, x, positions, i)
        x, a = checkpoint(_block_apply, *args, use_reentrant=False) \
            if remat else _block_apply(*args)
        if a is not None:
            aux = aux + a
    return (x, aux) if with_aux else x


@torch.no_grad()
def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    """tokens [B, S] -> float32 logits [B, S, padded_vocab]. The
    reference also returns the MoE load-balancing aux loss (0 without
    MoE); here ``forward_hidden(..., with_aux=True)`` gives it and
    ``loss_fn`` adds it."""
    return _logits(params, forward_hidden(params, tokens, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            seq_chunk: int = 512) -> torch.Tensor:
    """batch {"tokens": [B, S + 1] int32} -> the next-token
    cross-entropy plus the MoE aux loss (float32 scalar). The head
    (the embedding's transpose when tied) and the loss run through
    ``layers.chunked_lm_loss`` in chunks of ``min(seq_chunk, S)``
    tokens: the [B, S, V] float32 logits never exist."""
    tokens = batch["tokens"]
    x, aux = forward_hidden(params, tokens[:, :-1], cfg, with_aux=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps,
                   plus_one=cfg.post_norm)
    ce = L.chunked_lm_loss(x, _head(params, cfg), tokens[:, 1:],
                           final_softcap=cfg.final_softcap,
                           seq_chunk=min(seq_chunk, x.shape[1]))
    return ce + aux


def model_flops_per_token(cfg: LMConfig) -> float:
    """The reference's analytic model FLOPs a token, 6 N_active (the
    attention's own terms are counted apart): every parameter but the
    experts a token does not reach."""
    n = param_count(cfg)
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        n -= cfg.n_layers * (e - k) * 3 * cfg.d_model * cfg.moe.d_ff_expert
    return 6.0 * n


# ==========================================================================
# KV-cache serving path (prefill + decode)
# ==========================================================================

def cache_spec(cfg: LMConfig, batch: int, buf: int) -> dict:
    """The decode cache as a tree of ``(shape, dtype)`` (allocates
    nothing): ``layers`` (per layer ``k``, ``v`` [batch, n, Hkv, dh], or
    for MLA ``ckv`` [batch, n, kv_lora_rank] and ``kr`` [batch, n,
    qk_rope_dim]; n = min(window, buf) for a local layer's ring, else
    buf), ``pos`` [batch, buf] and, for local_global, ``pos_local``
    [batch, ring] int32: the sequence position held in each slot (-1 =
    empty)."""
    def layer(i):
        n = min(cfg.window, buf) if cfg.is_local(i) else buf
        if cfg.attention == "mla":
            m = cfg.mla
            return {"ckv": ((batch, n, m.kv_lora_rank), cfg.dtype),
                    "kr": ((batch, n, m.qk_rope_dim), cfg.dtype)}
        s = ((batch, n, cfg.n_kv_heads, cfg.head_dim), cfg.dtype)
        return {"k": s, "v": s}

    out = {"layers": [layer(i) for i in range(cfg.n_layers)],
           "pos": ((batch, buf), torch.int32)}
    if cfg.layer_pattern == "local_global":
        out["pos_local"] = ((batch, min(cfg.window, buf)), torch.int32)
    return out


def init_cache(cfg: LMConfig, batch: int, buf: int, *, device=None
               ) -> dict:
    """An empty decode cache for ``batch`` request slots of ``buf``
    positions on ``device`` (CUDA unless given): k, v (or ckv, kr) zero,
    positions -1."""
    dev = resolve_device(device)

    def make(leaf):
        shape, dtype = leaf
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)

    spec = cache_spec(cfg, batch, buf)
    out = {k: make(v) for k, v in spec.items() if k != "layers"}
    out["layers"] = [{k: make(v) for k, v in lc.items()}
                     for lc in spec["layers"]]
    return out


def _write_full(buf_arr: torch.Tensor, new: torch.Tensor, start: int
                ) -> torch.Tensor:
    """Write new [B, S, ...] at slots [start, start + S), in place."""
    buf_arr[:, start:start + new.shape[1]] = new.to(buf_arr.dtype)
    return buf_arr


class _RingWrites:
    """Scatter into ring caches at per-request slots ``positions % W``
    ([B, S] positions). Negative positions are DROPPED: right-padded
    prefill garbage must not be written at all, since slot g % W is
    shared with the real position g - W, which may still be inside the
    window. No host sync: a write is two accumulating scatters over
    every (request, index) pair, the first adding minus the old entry
    at each kept slot (leaving exactly 0), the second the new entry. A
    dropped pair adds zeros both times, which leaves its slot as it
    was; the kept slots of one write are distinct, so each ends holding
    exactly its new entry."""

    def __init__(self, positions: torch.Tensor):
        self.positions = positions
        self._keep = positions >= 0
        self._rows = torch.arange(positions.shape[0],
                                  device=positions.device)[:, None]

    def write(self, buf_arr: torch.Tensor, new: torch.Tensor
              ) -> torch.Tensor:
        idx = (self._rows, self.positions.long() % buf_arr.shape[1])
        keep = self._keep.reshape(self._keep.shape
                                  + (1,) * (buf_arr.dim() - 2))
        zero = buf_arr.new_zeros(())
        buf_arr.index_put_(idx, torch.where(keep, -buf_arr[idx], zero),
                           accumulate=True)
        buf_arr.index_put_(idx, torch.where(keep, new.to(buf_arr.dtype),
                                            zero), accumulate=True)
        return buf_arr


def _ring_prefill_pos(prefill_len: int, width: int, batch: int,
                      device=None) -> torch.Tensor:
    """Prefill write positions for a ring of ``width`` slots when no
    per-request lengths were given: the last ``width`` buffer positions,
    everything earlier dropped (-1)."""
    idx = torch.arange(prefill_len, dtype=torch.int32, device=device)[None]
    pos = torch.where(idx >= prefill_len - width, idx, -1)
    return pos.expand(batch, prefill_len)


def _attn_cached(p: dict, cfg: LMConfig, h: torch.Tensor,
                 positions: torch.Tensor, window: int, lc: dict,
                 k_pos: torch.Tensor, prefill_len: int,
                 ring: _RingWrites | None = None) -> torch.Tensor:
    """Attention through the cache ``lc`` (written in place): k and v,
    or MLA's latent ckv and kr. Prefill (``prefill_len`` > 0, positions
    = arange(P)): write the fresh entries (a ring only at ``ring``'s
    positions) and attend with them: an early prefill query needs keys
    older than a ring holds. Decode (positions [B, 1]): write, then
    attend over the cache through ``k_pos``."""
    if cfg.attention == "mla":
        new = dict(zip(("ckv", "kr"),
                       _mla_project(p["attn"], cfg, h, positions)))
    else:
        new = dict(zip(("k", "v"),
                       _gqa_project_kv(p["attn"], cfg, h, positions)))
    if prefill_len > 0:
        if window > 0 and ring is None:
            ring = _RingWrites(_ring_prefill_pos(
                prefill_len, lc[next(iter(new))].shape[1], h.shape[0],
                h.device))
        for name, t in new.items():
            if window > 0:
                ring.write(lc[name], t)
            else:
                _write_full(lc[name], t, 0)
        kv, k_positions = tuple(new.values()), positions
    else:
        bi = torch.arange(h.shape[0], device=h.device)[:, None]
        for name, t in new.items():
            if window > 0:
                ring.write(lc[name], t)
            else:
                lc[name][bi, positions.long()] = t.to(lc[name].dtype)
        kv, k_positions = tuple(lc[name] for name in new), k_pos
    if cfg.attention == "mla":
        return _mla_attention(p["attn"], cfg, h, positions,
                              cache_override=kv, k_positions=k_positions)
    return _gqa_attention(p["attn"], cfg, h, positions, window,
                          kv_override=kv, k_positions=k_positions)


def _layer_apply_cached(p: dict, cfg: LMConfig, x: torch.Tensor,
                        positions: torch.Tensor, window: int, lc: dict,
                        k_pos: torch.Tensor, prefill_len: int,
                        ring: _RingWrites | None = None) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norm)
    return _ffn_block(p, cfg, x, _attn_cached(p, cfg, h, positions, window,
                                              lc, k_pos, prefill_len,
                                              ring))[0]


@torch.no_grad()
def forward_with_cache(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                       cache: dict, positions: torch.Tensor,
                       valid_len: torch.Tensor | None = None):
    """Cache-threaded forward; returns (float32 logits [B, S, V], the
    cache, updated in place).

    Prefill: tokens [B, P], positions = arange(P) (1-D). ``valid_len``
    ([B] int32) gives the true prompt lengths of RIGHT-padded requests:
    ring caches then take only positions [len_b - W, len_b) per
    request, so padding garbage never evicts a real in-window key.
    Without it every request is taken as full-length. Logits come for
    all P positions (at P = 8192 and a 256,000-row vocab, 8.4 GB of
    float32).
    Decode: tokens [B, 1], positions [B, 1] (per request)."""
    prefill_len = tokens.shape[1] if positions.dim() == 1 else 0
    x = _embed(params, tokens, cfg)
    dev = x.device
    ring = None
    k_pos_local = None
    if prefill_len > 0:
        p_idx = torch.arange(prefill_len, dtype=torch.int32, device=dev)
        idx_b = p_idx.expand(tokens.shape[0], prefill_len)
        _write_full(cache["pos"], idx_b, 0)
        if valid_len is None:
            vl = torch.full((tokens.shape[0], 1), prefill_len,
                            dtype=torch.int32, device=dev)
        else:
            vl = torch.as_tensor(valid_len, dtype=torch.int32,
                                 device=dev).reshape(-1, 1)
        if "pos_local" in cache:
            w = cache["pos_local"].shape[1]
            ring = _RingWrites(torch.where((idx_b >= vl - w) & (idx_b < vl),
                                           idx_b, -1))
            ring.write(cache["pos_local"], ring.positions)
            k_pos_local = cache["pos_local"]
        elif cfg.window > 0:
            # uniform-window models keep a full-size cache (one slot per
            # position, no eviction): only the padding writes are masked
            ring = _RingWrites(torch.where(idx_b < vl, idx_b, -1))
    else:
        bi = torch.arange(tokens.shape[0], device=dev)[:, None]
        cache["pos"][bi, positions.long()] = positions.to(torch.int32)
        ring = _RingWrites(positions)
        if "pos_local" in cache:
            ring.write(cache["pos_local"], positions)
            k_pos_local = cache["pos_local"]

    for i, (lp, lc) in enumerate(zip(params["layers"], cache["layers"])):
        local = cfg.is_local(i)
        x = _layer_apply_cached(
            lp, cfg, x, positions, cfg.layer_window(i), lc,
            k_pos_local if local else cache["pos"], prefill_len,
            ring if local or cfg.layer_pattern == "global" else None)
    return _logits(params, x, cfg), cache
