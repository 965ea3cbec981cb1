"""Wrappers of the Multi-Jump kernel (``csrc/multi_jump.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Kernel, check_int32, stream_of
from repro_torch.kernels.multi_jump.ref import (ref_multi_jump_sweep,
                                                ref_multi_jump_sweeps)

_MAX_SWEEPS = 64
MAX_TILE = 6144               # two int tiles fill 48 KB of smem
KERNEL = Kernel("multi_jump", "multi_jump_sweeps",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p])


def _pad_to(pi: torch.Tensor, tile: int) -> torch.Tensor:
    """A copy of π padded to a tile multiple; padded entries are
    self-roots (chase no-ops)."""
    v = pi.shape[0]
    target = ((v + tile - 1) // tile) * tile
    pad = torch.arange(v, target, dtype=pi.dtype, device=pi.device)
    return torch.cat([pi, pad])


def _sweeps(pi: torch.Tensor, tile: int, rounds: int, max_sweeps: int
            ) -> torch.Tensor:
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")
    v = pi.shape[0]
    if pi.device.type == "cpu":
        padded = _pad_to(pi, tile)
        if max_sweeps == 1:
            return ref_multi_jump_sweep(padded, tile, rounds)[:v]
        return ref_multi_jump_sweeps(padded, tile, rounds, max_sweeps)[:v]
    check_int32("pi", pi, 1)
    padded = _pad_to(pi, tile)
    if v == 0:
        return padded
    count = torch.empty(1, dtype=torch.int32, device=pi.device)
    with torch.cuda.device(pi.device):
        KERNEL.launch(padded.data_ptr(), padded.shape[0], tile, rounds,
                      max_sweeps, count.data_ptr(), stream_of(pi))
    return padded[:v]


def multi_jump(pi: torch.Tensor, *, tile: int = 512, rounds: int = 2
               ) -> torch.Tensor:
    """One blocked Multi-Jump sweep (each tile chased ``rounds``
    levels). Returns a new π; a CPU ``pi`` runs the plain version."""
    return _sweeps(pi, tile, rounds, 1)


def full_compress(pi: torch.Tensor, *, tile: int = 512, rounds: int = 2
                  ) -> torch.Tensor:
    """Compress to stars: blocked sweeps until one changes nothing (at
    most 64), all in ONE launch with a device-side changed flag.
    Returns a new π; a CPU ``pi`` runs the plain version."""
    return _sweeps(pi, tile, rounds, _MAX_SWEEPS)
