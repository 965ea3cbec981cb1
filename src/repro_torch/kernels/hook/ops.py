"""Wrapper of the hook kernel (``csrc/hook.cu``).

The source holds two bodies:

* ``hook_edges_pallas`` -> ``hook_tiles``: the TPU kernel's edge tiles
  in ascending order, tile t seeing the hooks of tiles < t (one block);
* ``hook_edges_snapshot`` -> ``hook_snapshot``: every edge hooks from
  one π snapshot, the TPU kernel at one tile over the whole edge list
  (every SM).

Each body counts its own launches (``TILES``, ``SNAPSHOT``);
``KERNEL.launches`` is their sum. There is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Bodies, Kernel, check_int32, stream_of
from repro_torch.kernels.hook.ref import ref_hook_round, ref_hook_tiled

MAX_EDGE_TILE = 6144          # (hi, lo) pairs of a tile fill 48 KB of smem
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
TILES = Kernel("hook", "hook_tiles", [_P, _P, _L, _I, _I, _P])
SNAPSHOT = Kernel("hook", "hook_snapshot", [_P, _P, _P, _L, _I, _P])
KERNEL = Bodies(TILES, SNAPSHOT)


def _check(pi: torch.Tensor, edges: torch.Tensor) -> None:
    check_int32("pi", pi, 1)
    check_int32("edges", edges, 2)
    if edges.shape[1] != 2 or edges.device != pi.device:
        raise ValueError("edges must be [E, 2] on pi's device")


def hook_edges_pallas(pi: torch.Tensor, edges: torch.Tensor, *,
                      edge_tile: int = 1024, lift_steps: int = 2
                      ) -> torch.Tensor:
    """Hook all ``edges`` (int32 [E, 2]) into π in tiles of
    ``edge_tile``, tiles in ascending order; the edge list counts as
    padded with (0, 0) rows to a multiple of the tile, as in the
    reference. Returns a new π. A CPU ``pi`` runs the plain version; a
    CUDA one the kernel."""
    if not 1 <= edge_tile <= MAX_EDGE_TILE:
        raise ValueError(f"edge_tile must be in [1, {MAX_EDGE_TILE}], "
                         f"got {edge_tile}")
    e = edges.shape[0]
    if pi.device.type == "cpu":
        pad = (-e) % edge_tile
        if pad:
            edges = torch.cat([edges, edges.new_zeros((pad, 2))], dim=0)
        return ref_hook_tiled(pi, edges, edge_tile, lift_steps)
    _check(pi, edges)
    out = pi.clone()
    if e == 0:
        return out
    with torch.cuda.device(pi.device):
        TILES.launch(out.data_ptr(), edges.data_ptr(), e, edge_tile,
                     lift_steps, stream_of(pi))
    return out


def hook_edges_snapshot(pi: torch.Tensor, edges: torch.Tensor, *,
                        lift_steps: int = 2) -> torch.Tensor:
    """Hook all ``edges`` (int32 [E, 2]) into π, every read from the
    input π: the hook kernel at one tile over the whole edge list, equal
    to ``ref_hook_round`` (the torch-ops ``hook_edges``). Returns a new
    π; ``pi`` is not written. A CPU ``pi`` runs the plain version; a
    CUDA one the kernel."""
    if pi.device.type == "cpu":
        return ref_hook_round(pi, edges, lift_steps)
    _check(pi, edges)
    out = pi.clone()
    if edges.shape[0] == 0:
        return out
    with torch.cuda.device(pi.device):
        SNAPSHOT.launch(pi.data_ptr(), out.data_ptr(), edges.data_ptr(),
                        edges.shape[0], lift_steps, stream_of(pi))
    return out
