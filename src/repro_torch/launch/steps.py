"""Per-(arch × shape) step builders, the port of ``repro.launch.steps``
for the serving steps of the recsys and LM families.

``build_cell(arch_id, shape, device=...)`` returns a ``Cell``: the step
callable and the ``(shape, dtype)`` specs of its arguments. Building a
cell allocates nothing. A step takes the model and host (numpy) inputs,
moves the inputs to the cell's device and runs there:

  * ``serve``     — ``step(model, batch)`` -> logits [B];
  * ``retrieval`` — ``step(model, batch, candidate_ids)`` -> scores [N];
  * ``prefill``   — ``step(params, tokens, cache)`` -> (logits [B, S, V],
                    cache): the prompt pass over ``tokens`` [B, S];
  * ``decode``    — ``step(params, tokens, positions, cache)`` ->
                    (logits [B, 1, V], cache): one token per request at
                    ``positions`` [B].

The cache is a device tree (``transformer.init_cache``), updated in
place.

No shardings and no donation: the port runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.graphs.device import resolve_device
from repro_torch.models import recsys
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple                    # (shape, dtype) spec trees


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device)


def _batch_on(batch: dict, device: torch.device) -> dict:
    return {k: _on(v, device) for k, v in batch.items()}


def _build_recsys(arch_id: str, shape: str, device: torch.device) -> Cell:
    mod = get_arch(arch_id)
    kind = mod.step_kind(shape)
    if kind == "train":
        raise NotImplementedError(
            f"{arch_id} {shape}: training is not ported yet (ROADMAP "
            "A11, recsys training: the embedding_bag and segment_reduce "
            "kernels need a torch.autograd.Function with a kernel "
            "backward)")
    cfg = mod.make_config()
    specs = mod.input_specs(shape)
    params = {n: (s, cfg.dtype)
              for n, s in recsys.param_shapes(cfg).items()}
    if kind == "serve":
        def step(model, batch):
            return recsys.forward(model, _batch_on(batch, device))
        return Cell(arch_id, shape, kind, step,
                    args=(params, specs["batch"]))

    def step(model, batch, candidate_ids):
        return recsys.retrieval_scores(model, _batch_on(batch, device),
                                       _on(candidate_ids, device))
    return Cell(arch_id, shape, kind, step,
                args=(params, specs["batch"], specs["candidate_ids"]))


def _build_lm(arch_id: str, shape: str, device: torch.device) -> Cell:
    mod = get_arch(arch_id)
    kind = mod.step_kind(shape)
    if kind == "train":
        raise NotImplementedError(
            f"{arch_id} {shape}: training is not ported yet (ROADMAP A11, "
            "LM training)")
    cfg = mod.make_config()
    specs = mod.input_specs(shape)
    params = T.flatten(T.param_shapes(cfg))
    params = {n: (s, cfg.dtype) for n, s in params.items()}
    if kind == "prefill":
        def step(model, tokens, cache):
            tokens = _on(tokens, device)
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=device)
            return T.forward_with_cache(model, tokens, cfg, cache,
                                        positions)
        return Cell(arch_id, shape, kind, step,
                    args=(params, specs["tokens"], specs["cache"]))

    def step(model, tokens, positions, cache):
        return T.forward_with_cache(model, _on(tokens, device)[:, None], cfg,
                                    cache, _on(positions, device)[:, None])
    return Cell(arch_id, shape, kind, step,
                args=(params, specs["tokens"], specs["positions"],
                      specs["cache"]))


def build_cell(arch_id: str, shape: str, *, device=None) -> Cell:
    """The cell of ``(arch_id, shape)`` on ``device`` (CUDA unless
    given; raises without CUDA unless ``device="cpu"``)."""
    if arch_id == "cc-adaptive":
        raise NotImplementedError(
            "the distributed CC cell is not ported yet (ROADMAP A10)")
    device = resolve_device(device)
    # get_arch raises for the ids that are not ported (MLA, MoE, GNN)
    if get_arch(arch_id).FAMILY == "lm":
        return _build_lm(arch_id, shape, device)
    return _build_recsys(arch_id, shape, device)
