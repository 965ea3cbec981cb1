"""Wrappers of the Multi-Jump kernel (``csrc/multi_jump.cu``).

The source holds two bodies, and the entry point picks one:

* ``multi_jump`` (one sweep) and ``sequential_sweeps`` -> the
  sequential body ``multi_jump_sweeps`` (one block, vertex tiles in
  ascending order, bit-equal to ``ref_multi_jump_sweep``);
* ``full_compress`` -> the fixpoint body ``compress_roots`` (every SM,
  each vertex chased to its root), bit-equal to ``ref_full_compress`` on
  every forest.

There is no fallback between them: a body that fails to build or launch
raises. Each body counts its own launches (``SEQUENTIAL``, ``ROOTS``);
``KERNEL.launches`` is their sum.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Bodies, Kernel, check_int32, stream_of
from repro_torch.kernels.multi_jump.ref import (ref_multi_jump_sweep,
                                                ref_multi_jump_sweeps)

MAX_SWEEPS = 64
MAX_TILE = 6144               # two int tiles fill 48 KB of smem
SEQUENTIAL = Kernel("multi_jump", "multi_jump_sweeps",
                    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
ROOTS = Kernel("multi_jump", "compress_roots",
               [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p])
KERNEL = Bodies(SEQUENTIAL, ROOTS)


def _pad_to(pi: torch.Tensor, tile: int) -> torch.Tensor:
    """A copy of π padded to a tile multiple; padded entries are
    self-roots (chase no-ops)."""
    v = pi.shape[0]
    target = ((v + tile - 1) // tile) * tile
    pad = torch.arange(v, target, dtype=pi.dtype, device=pi.device)
    return torch.cat([pi, pad])


def _check_tile(tile: int) -> None:
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")


def sequential_sweeps(pi: torch.Tensor, *, tile: int, rounds: int,
                      max_sweeps: int) -> torch.Tensor:
    """Blocked sweeps in the TPU kernel's order (vertex tiles ascending,
    each chased ``rounds`` levels with continuous write-back) until one
    changes nothing, at most ``max_sweeps``, in ONE launch of the
    sequential body. Returns a new π; a CPU ``pi`` runs the plain
    version."""
    _check_tile(tile)
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
    with torch.cuda.device(pi.device):
        SEQUENTIAL.launch(padded.data_ptr(), padded.shape[0], tile, rounds,
                          max_sweeps, stream_of(pi))
    return padded[:v]


def multi_jump(pi: torch.Tensor, *, tile: int = 512, rounds: int = 2
               ) -> torch.Tensor:
    """One blocked Multi-Jump sweep (each tile chased ``rounds``
    levels). Returns a new π; a CPU ``pi`` runs the plain version."""
    return sequential_sweeps(pi, tile=tile, rounds=rounds, max_sweeps=1)


def full_compress(pi: torch.Tensor, *, tile: int = 512, rounds: int = 2
                  ) -> torch.Tensor:
    """Compress to stars: every vertex points at its root. Returns a new
    π. A CPU ``pi`` runs the plain version, blocked sweeps (``tile``,
    ``rounds``) until one changes nothing, at most 64, as the reference
    does; a CUDA one the fixpoint body in ONE launch, which reaches the
    same π on every forest whatever the tiles (see ``csrc/multi_jump.cu``)
    and returns within 32 rounds on any other input."""
    _check_tile(tile)
    if pi.device.type == "cpu":
        return sequential_sweeps(pi, tile=tile, rounds=rounds,
                                 max_sweeps=MAX_SWEEPS)
    check_int32("pi", pi, 1)
    out = pi.clone()
    if out.shape[0] == 0:
        return out
    flag = torch.zeros(1, dtype=torch.int32, device=pi.device)
    with torch.cuda.device(pi.device):
        ROOTS.launch(out.data_ptr(), out.shape[0], flag.data_ptr(),
                     stream_of(pi))
    return out
