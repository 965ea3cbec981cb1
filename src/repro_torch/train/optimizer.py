"""Hand-rolled optimizers, the port of ``repro.train.optimizer``: AdamW,
SGD-momentum, global-norm clipping, cosine / constant schedules.

Optimizers are (init, update) pairs over name-keyed dicts of tensors
(``named`` turns a module or a nested dict into one). The update math
runs in fp32 and casts back on store, as the reference's does, with its
rounding kept step for step:

  * an update ``-lr * delta`` is cast to the parameter's dtype, and
    ``apply_updates`` adds it in that dtype: there is no fp32 master
    copy, so a bfloat16 parameter drops an update under half its ulp;
  * the moments are stored in ``moment_dtype``, the parameter's own
    dtype when it is None;
  * weight decay is added to ``delta`` (``delta + wd * p``) and only for
    matrices (``p.ndim >= 2``), which is not ``torch.optim.AdamW``'s
    decoupled ``p *= 1 - lr * wd``; ``AdamWConfig.decays`` names the
    decayed parameters instead where the port's layout differs from
    the reference's (the LM's layers, which the reference stacks);
  * the step, the schedules and the bias corrections are float32 tensor
    arithmetic on the step's device (``t = step + 1``, ``b1 ** t``).

Each ``update`` returns new moment tensors; ``apply_updates`` writes the
parameters in place (callers hold it under ``torch.no_grad()``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn


class Optimizer(NamedTuple):
    init: Callable      # params -> opt_state
    # (grads, opt_state, params, step) -> (updates, new_state, gnorm)
    update: Callable


def named(tree) -> dict:
    """The tensors of a parameter tree by dotted name: a module's
    ``named_parameters()``, or a (nested) dict / list of tensors whose
    keys and indices join with dots (``{"mlp": {"ws": [a, b]}}`` ->
    ``mlp.ws.0``, ``mlp.ws.1``)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if not isinstance(tree, dict):
        raise TypeError(f"not a parameter tree: {type(tree).__name__}")
    out = {}
    for key, val in tree.items():
        if isinstance(val, (dict, list, tuple, nn.Module)):
            out.update({f"{key}.{k}": v for k, v in named(val).items()})
        else:
            out[str(key)] = val
    return out


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in named(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, each
    in its own dtype; the norm before clipping)."""
    grads = named(grads)
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, \
        norm


# ==========================================================================
# Schedules
# ==========================================================================

def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = _step_f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.tensor(lr_val, dtype=torch.float32)


# ==========================================================================
# AdamW
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Optional[torch.dtype] = None   # None = same as param
    # (name, param) -> whether it decays; None = the matrices (ndim >= 2)
    decays: Optional[Callable[[str, torch.Tensor], bool]] = None


def adamw(cfg: AdamWConfig) -> Optimizer:
    lr_fn = cfg.lr if callable(cfg.lr) else constant_schedule(cfg.lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.moment_dtype or p.dtype,
                               device=p.device)
        params = named(params)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()}}

    def update(grads, state, params, step):
        if cfg.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            grads, gnorm = named(grads), global_norm(grads)
        params = named(params)
        t = _step_f32(step) + 1.0
        lr = lr_fn(step)
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)

        def upd(n, g, m, v, p):
            gf = g.float()
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            mh = mf / bc1
            vh = vf / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            decays = p.dim() >= 2 if cfg.decays is None else \
                cfg.decays(n, p)
            if cfg.weight_decay > 0 and decays:
                delta = delta + cfg.weight_decay * p.float()
            return ((-lr * delta).to(p.dtype), mf.to(m.dtype),
                    vf.to(v.dtype))

        updates, new_m, new_v = {}, {}, {}
        for n, g in grads.items():
            updates[n], new_m[n], new_v[n] = upd(
                n, g, state["m"][n], state["v"][n], params[n])
        return updates, {"m": new_m, "v": new_v}, gnorm

    return Optimizer(init=init, update=update)


# ==========================================================================
# SGD (momentum)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: Callable | float = 1e-2
    momentum: float = 0.9
    clip_norm: float = 0.0


def sgd(cfg: SGDConfig) -> Optimizer:
    lr_fn = cfg.lr if callable(cfg.lr) else constant_schedule(cfg.lr)

    def init(params):
        if cfg.momentum == 0.0:
            return {}
        return {"mu": {n: torch.zeros_like(p)
                       for n, p in named(params).items()}}

    def update(grads, state, params, step):
        if cfg.clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        else:
            grads, gnorm = named(grads), global_norm(grads)
        params = named(params)
        lr = lr_fn(step)
        if cfg.momentum == 0.0:
            updates = {n: (-lr * g.float()).to(params[n].dtype)
                       for n, g in grads.items()}
            return updates, state, gnorm
        # in mu's dtype, the momentum constant included, as jnp takes a
        # Python float against a bfloat16 array
        new_mu = {}
        for n, g in grads.items():
            mu = state["mu"][n]
            new_mu[n] = torch.tensor(cfg.momentum, dtype=mu.dtype) * mu \
                + g.to(mu.dtype)
        updates = {n: (-lr * mu.float()).to(params[n].dtype)
                   for n, mu in new_mu.items()}
        return updates, {"mu": new_mu}, gnorm

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    """``p + u`` in each parameter's dtype, written into ``params`` in
    place; returns ``params``."""
    named_params = named(params)
    for n, u in named(updates).items():
        named_params[n].add_(u)
    return params
