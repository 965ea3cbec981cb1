"""Mixture-of-Experts FFN, the port of ``repro.models.moe``: GShard-style
top-k dispatch with a per-expert capacity, for grok-1 (8 experts, top-2)
and phi3.5-moe (16 experts, top-2).

The semantics are the reference's exactly:

* the router runs in float32 (its parameter is float32 whatever the
  model dtype), then softmax; the top k experts are taken in the order
  ``jax.lax.top_k`` gives, ties to the lower expert (a stable descending
  sort), and their gates renormalised with a 1e-9 floor;
* tokens go through in chunks of ``min(dispatch_chunk, T)`` (the last
  one zero-padded, its padding routed like any token); capacity is set
  per chunk, ``max(int(capacity_factor * chunk * k / E), 1)``;
* a token's rank in its expert's buffer comes from a one-hot cumsum in
  choice-major order, so every first choice ranks before any second
  choice; ranks at or past the capacity are dropped (they add zeros at
  slot ``e * cap``);
* the experts are a batched SwiGLU over [E, cap, D] (``torch.bmm``);
* the combine rounds the gate weights to the model dtype before the
  product and adds each token's k results into a zero row. With k = 2 a
  row is 0 + a + b, the same in any order, so the bfloat16 result does
  not depend on the order of the device's atomics.

No kernel of the repo computes this: the reference runs it as XLA
einsums and scatter-adds, and the port as torch matrix products and
index ops.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dispatch_chunk: int = 16384     # tokens a dispatch chunk: bounds the
                                    # [E, cap, d_ff] expert hiddens


def capacity(cfg: MoEConfig, chunk: int) -> int:
    """Rows an expert's buffer holds for a chunk of ``chunk`` tokens."""
    return max(int(cfg.capacity_factor * chunk * cfg.top_k
                   / cfg.num_experts), 1)


def moe_params(d_model: int, cfg: MoEConfig, dtype: torch.dtype, *,
               generator: torch.Generator, device=None) -> dict:
    """Router [D, E] float32 N(0, 1/D); experts ``w_gate``, ``w_up``
    [E, D, F] N(0, 1/D) and ``w_down`` [E, F, D] N(0, 1/F) in ``dtype``,
    drawn one expert at a time (a float32 draw of a whole grok-1 layer
    would take 6.4 GB)."""
    e, f = cfg.num_experts, cfg.d_ff_expert
    g = {"generator": generator, "device": device}

    def experts(din, dout):
        w = torch.empty((e, din, dout), dtype=dtype, device=device)
        for i in range(e):
            w[i] = normal_init((din, dout), din ** -0.5, dtype, **g)
        return w

    return {"router": normal_init((d_model, e), d_model ** -0.5,
                                  torch.float32, **g),
            "w_gate": experts(d_model, f), "w_up": experts(d_model, f),
            "w_down": experts(f, d_model)}


def route(params: dict, xt: torch.Tensor, cfg: MoEConfig, cap: int) -> dict:
    """The router's decisions for one chunk xt [T, D]: ``probs`` [T, E]
    float32, ``gate_idx`` / ``gate_vals`` [T, k] (renormalised),
    ``expert`` [kT] (choice-major: ``gate_idx.T`` flattened), ``pos``
    [kT] (rank in the expert's buffer), ``keep`` [kT] (pos < cap) and the
    load-balancing ``aux`` loss."""
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    top1 = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(probs.mean(dim=0) * top1)
    expert = gate_idx.T.reshape(-1)
    ranks = torch.cumsum(F.one_hot(expert, e), dim=0) - 1
    pos = ranks.gather(1, expert[:, None])[:, 0]
    return {"probs": probs, "gate_idx": gate_idx, "gate_vals": gate_vals,
            "expert": expert, "pos": pos, "keep": pos < cap, "aux": aux}


def _dispatch_chunk(params: dict, xt: torch.Tensor, cfg: MoEConfig,
                    cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk [T, D] through router, dispatch, experts and combine."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    r = route(params, xt, cfg, cap)
    keep = r["keep"]
    tok = torch.arange(t, device=xt.device).repeat(k)
    slot = r["expert"] * cap + torch.where(keep, r["pos"], 0)
    rows = torch.where(keep[:, None], xt[tok], 0)
    buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_add_(0, slot, rows).view(e, cap, d)
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    out = torch.bmm(h, params["w_down"]).reshape(e * cap, d)
    w = (r["gate_vals"].T.reshape(-1) * keep).to(xt.dtype)
    combined = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    combined.index_add_(0, tok, out[slot] * w[:, None])
    return combined, r["aux"]


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], the aux loss averaged over
    chunks)."""
    b, s, d = x.shape
    t = b * s
    chunk = min(cfg.dispatch_chunk, t)
    nchunk = -(-t // chunk)
    cap = capacity(cfg, chunk)
    xt = x.reshape(t, d)
    if nchunk * chunk > t:
        xt = F.pad(xt, (0, 0, 0, nchunk * chunk - t))
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunk):
        out, a = _dispatch_chunk(params, xt[c * chunk:(c + 1) * chunk], cfg,
                                 cap)
        outs.append(out)
        aux = aux + a
    return torch.cat(outs)[:t].reshape(b, s, d), aux / nchunk
