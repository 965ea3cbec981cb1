"""Elastic scaling: restore any checkpoint onto any mesh, the port of
``repro.launch.elastic``.

Checkpoints are mesh-agnostic (full arrays and a manifest,
``train/checkpoint.py``), so rescaling is a ``restore`` into a state
built on the new mesh. The launcher-side pieces:

  * ``reshard_plan``: given a TrainState and a target mesh, the
    reference's tree (``params``, ``opt``, ``step``) with each leaf's
    placement. The port shards no parameters (a state lives on one
    device), so every leaf holds the device of the mesh's first slot;
  * ``rescale``: restore a checkpoint into a state of the given one's
    tree built on that device (``checkpoint.restore`` casts and copies
    each leaf in place), so a state saved on the card restores on the
    CPU and the other way round;
  * ``ElasticController``: decides when to rescale, from the step
    watchdog's slow-step streak and a healthy-host count (fed by the
    cluster manager in a deployment, by tests here), and emits the new
    data-parallel width. Host logic, as the reference's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import named


def reshard_plan(state_struct: dict, mesh: Mesh) -> dict:
    """``{"params": {name: device}, "opt": {key: {name: device}},
    "step": device}`` for a TrainState ``state_struct``: the device of
    the mesh's first slot for every leaf."""
    dev = mesh.slot_devices()[0]
    return {
        "params": {n: dev for n in named(state_struct["params"])},
        "opt": {k: {n: dev for n in named(v)}
                for k, v in state_struct["opt"].items()},
        "step": dev,
    }


def _empty_on(tree, dev: torch.device):
    """``tree`` with every tensor replaced by an empty one on ``dev``
    (shape, dtype and ``requires_grad`` kept); a module is copied with
    its parameters replaced."""
    def empty(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device=dev
                           ).requires_grad_(t.requires_grad)

    if isinstance(tree, nn.Module):
        memo = {id(p): nn.Parameter(empty(p), p.requires_grad)
                for p in tree.parameters()}
        return copy.deepcopy(tree, memo)
    if isinstance(tree, torch.Tensor):
        return empty(tree)
    if isinstance(tree, dict):
        return {k: _empty_on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_empty_on(v, dev) for v in tree]
    return tree


def rescale(ckpt_dir: str, state_struct: dict, mesh: Mesh,
            step: Optional[int] = None) -> dict:
    """Restore the newest (or given) checkpoint into a state of
    ``state_struct``'s tree on ``mesh`` (its first slot's device): the
    elastic-rescale path. A checkpoint taken on the card restores on a
    CPU mesh unchanged, and back."""
    plan = reshard_plan(state_struct, mesh)
    like = _empty_on(state_struct, plan["step"])
    return ckpt_lib.restore(ckpt_dir, like=like, step=step)


@dataclasses.dataclass
class ElasticController:
    """Policy: drop to the largest power-of-two healthy data-parallel
    width; rescale up again when hosts return. Hysteresis via
    ``min_steps_between`` so transient stragglers don't thrash."""

    dp_width: int
    min_steps_between: int = 100
    _last_change: int = -10**9

    def decide(self, step: int, healthy_hosts: int,
               slow_streak: int = 0) -> Optional[int]:
        """Returns a new dp width, or None to keep the current one."""
        if step - self._last_change < self.min_steps_between:
            return None
        target = 1
        while target * 2 <= healthy_hosts:
            target *= 2
        if slow_streak >= 3 and target >= 2:
            target //= 2          # a persistent straggler: shed a host
        if target != self.dp_width and target >= 1:
            self._last_change = step
            self.dp_width = target
            return target
        return None
