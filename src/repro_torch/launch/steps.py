"""Per-(arch × shape) step builders, the port of ``repro.launch.steps``
for the recsys family's serving steps.

``build_cell(arch_id, shape, device=...)`` returns a ``Cell``: the step
callable and the ``(shape, dtype)`` specs of its arguments. Building a
cell allocates nothing. A step takes the model and host (numpy) inputs,
moves the inputs to the cell's device and runs there:

  * ``serve``     — ``step(model, batch)`` -> logits [B];
  * ``retrieval`` — ``step(model, batch, candidate_ids)`` -> scores [N].

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


def build_cell(arch_id: str, shape: str, *, device=None) -> Cell:
    """The cell of ``(arch_id, shape)`` on ``device`` (CUDA unless
    given; raises without CUDA unless ``device="cpu"``)."""
    if arch_id == "cc-adaptive":
        raise NotImplementedError(
            "the distributed CC cell is not ported yet (ROADMAP A10)")
    # get_arch raises for the lm and gnn ids: only recsys is ported
    return _build_recsys(arch_id, shape, resolve_device(device))
