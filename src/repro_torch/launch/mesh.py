"""Shard meshes: the port of ``repro.launch.mesh``.

The reference names its devices through ``jax.sharding.Mesh``. Here a
``Mesh`` is a grid of shard *slots*, each pinned to a ``torch.device``,
laid out over named axes. One device may hold several slots: that is
how one GPU (or the CPU, in tests) carries an N-slot mesh, the part the
reference's tests give to XLA's forced host devices. The multi-shard
engine (``core.distributed``) runs every slot's work from one host
process, single-controller, as the reference's ``shard_map`` does.

Axes, as in the reference:

  * ``pod``   — inter-pod data parallelism;
  * ``data``  — data parallelism / the FSDP shard axis;
  * ``model`` — tensor / expert parallelism.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A grid of shard slots over named axes, each slot a
    ``torch.device``.

    ``devices`` is a flat sequence (one axis) or a nested one whose
    shape matches ``axis_names``; entries are ``torch.device``s or their
    spellings (``"cuda:0"``, ``"cpu"``)."""

    def __init__(self, devices, axis_names=("data",)):
        axis_names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not match "
                             f"the axes {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one slot")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate axis names {axis_names}")
        out = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            out[idx] = torch.device(d)
        self.devices = out
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slot_devices(self, axis_names=None) -> tuple:
        """The device of each shard slot when data is split over
        ``axis_names`` (all axes when None), in shard order: the named
        axes flattened in the order given. Slots along the other axes
        would hold replicas of the same shard; the first of them is
        named."""
        names = self.axis_names if axis_names is None else tuple(axis_names)
        missing = [a for a in names if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh's "
                             f"{self.axis_names}")
        idx = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        n = int(np.prod([self.devices.shape[i] for i in idx]))
        grid = self.devices.transpose(idx + rest).reshape(n, -1)
        return tuple(grid[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(n: int = 1, device=None, axis: str = "data") -> Mesh:
    """An ``n``-slot mesh over one axis (the reference's
    ``make_cpu_mesh``): the slots go round-robin over the visible CUDA
    devices, or all on ``device`` when given. Without CUDA it raises
    unless ``device="cpu"``."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n}")
    if device is not None:
        return Mesh([torch.device(device)] * n, (axis,))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % count) for i in range(n)],
                (axis,))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: 16x16 chips (2x16x16 with
    ``multi_pod``). Raises: a pod of chips has no one-GPU analogue.
    The dry-run (``launch.dryrun``) runs every cell on one card's worth
    of ``meta`` tensors instead."""
    raise NotImplementedError(
        f"the production mesh ({'2x16x16' if multi_pod else '16x16'} "
        "chips) has no one-GPU analogue: the port runs on one card "
        "(python -m repro_torch.launch.dryrun dry-runs every cell on "
        "meta tensors)")


def fsdp_axes(multi_pod: bool = False):
    """The axis group batch/FSDP dims shard over."""
    return ("pod", "data") if multi_pod else ("data",)


def all_axes(multi_pod: bool = False):
    return ("pod", "data", "model") if multi_pod else ("data", "model")
