"""Wrapper of the edge-tiled hook kernel (``csrc/hook.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Kernel, check_int32, stream_of
from repro_torch.kernels.hook.ref import ref_hook_tiled

MAX_EDGE_TILE = 6144          # (hi, lo) pairs of a tile fill 48 KB of smem
KERNEL = Kernel("hook", "hook_tiles",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
    check_int32("pi", pi, 1)
    check_int32("edges", edges, 2)
    if edges.shape[1] != 2 or edges.device != pi.device:
        raise ValueError("edges must be [E, 2] on pi's device")
    out = pi.clone()
    if e == 0:
        return out
    with torch.cuda.device(pi.device):
        KERNEL.launch(out.data_ptr(), edges.data_ptr(), e, edge_tile,
                      lift_steps, stream_of(pi))
    return out
