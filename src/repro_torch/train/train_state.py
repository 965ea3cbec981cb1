"""TrainState, the port of ``repro.train.train_state``: the checkpointable
unit (params + optimizer state + step).

A plain dict with the reference's keys: ``params`` (a module, or a dict
of tensors), ``opt`` (the optimizer's moments by parameter name: ``m`` /
``v`` for AdamW, ``mu`` for SGD-momentum) and ``step`` (an int32 scalar
on the parameters' device).

The step updates the state in place: new moments replace the old ones
in ``state["opt"]``, and parameters and ``step`` are written in place
under ``torch.no_grad()``. That is the port's analogue of the
reference's ``donate_argnums``: the old state's buffers are not kept.

The reference's ``state_sharding_tree`` (NamedShardings for every leaf
of a mesh) has no one-device analogue and is not ported.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.optimizer import Optimizer, apply_updates, named


def create(params: Any, opt: Optimizer) -> dict:
    """A fresh state over ``params``, which the step trains in place.
    Every parameter must require grad: the model is built trainable
    (``recsys.init(..., requires_grad=True)``), as ``create`` takes the
    parameters as given, like the reference's."""
    leaves = named(params)
    frozen = [n for n, p in leaves.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"parameters {frozen} do not require grad: build "
                         "them trainable")
    device = next(iter(leaves.values())).device if leaves else None
    return {
        "params": params,
        "opt": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    accum_steps: int = 1,
                    accum_dtype: torch.dtype | None = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar``; ``batch`` is a dict of tensors
    on the parameters' device. ``metrics`` holds ``loss`` (float32) and
    ``grad_norm`` (before clipping), both device scalars.

    ``accum_steps`` > 1 splits the batch into microbatches on the
    leading dim; their gradients are summed in float32 (or
    ``accum_dtype``), then divided by ``accum_steps`` and cast to each
    parameter's dtype, as the reference's scan does. The update runs
    under the profiler range ``optimizer``.
    """

    def grads_of(params, batch):
        leaves = named(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def step(state: dict, batch: dict):
        params = named(state["params"])
        if accum_steps == 1:
            loss, grads = grads_of(state["params"], batch)
        else:
            for k, x in batch.items():
                if x.shape[0] % accum_steps:
                    raise ValueError(f"batch {k!r} of {x.shape[0]} rows "
                                     f"does not split into {accum_steps}")
            micro = {k: x.chunk(accum_steps) for k, x in batch.items()}
            g_sum = {n: torch.zeros(p.shape, dtype=accum_dtype or
                                    torch.float32, device=p.device)
                     for n, p in params.items()}
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=state["step"].device)
            for i in range(accum_steps):
                l, g = grads_of(state["params"],
                                {k: v[i] for k, v in micro.items()})
                for n, gn in g.items():
                    g_sum[n] = g_sum[n] + gn.to(g_sum[n].dtype)
                l_sum = l_sum + l
            loss = l_sum / accum_steps
            grads = {n: (g_sum[n] / accum_steps).to(p.dtype)
                     for n, p in params.items()}
        return apply_gradients(state, opt, loss, grads)

    return step


def apply_gradients(state: dict, opt: Optimizer, loss: torch.Tensor,
                    grads: dict):
    """The update of a step: ``opt`` on ``grads`` (by parameter name),
    the parameters and ``step`` written in place, under the profiler
    range ``optimizer``. Returns ``(state, {"loss", "grad_norm"})``."""
    params = named(state["params"])
    with torch.no_grad(), torch.profiler.record_function("optimizer"):
        updates, state["opt"], gnorm = opt.update(
            grads, state["opt"], params, state["step"])
        apply_updates(params, updates)
        state["step"] += 1
    return state, {"loss": loss.float(), "grad_norm": gnorm}


def param_count(state: dict) -> int:
    return sum(p.numel() for p in named(state["params"]).values())
