"""Wrappers of the fused segment-scan kernel (``csrc/cc_fused.cu``): one
graph's scan (``fused_segment_scan``, launches counted on ``KERNEL``),
the dynamic engine's id-recording scan that records the spanning forest
as it hooks (``fused_forest_scan``, on ``FOREST``) and a shape bucket's
scan over all its graphs at once
(``fused_segment_scan_batched``, counted on ``BATCHED``: the block body,
one graph a block with pi in shared memory, on ``BLOCK``; the grid body
for larger graphs on ``GRID``; ``batched_body`` names the one a bucket
takes)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rounds import compress_fuel
from repro_torch.kernels import Bodies, Kernel, check_int32, stream_of
from repro_torch.kernels.cc_fused.ref import (ref_forest_scan,
                                              ref_segment_scan,
                                              ref_segment_scan_batched)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("cc_fused", "cc_fused_scan",
                [_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P])
FOREST = Kernel("cc_fused", "cc_fused_forest_scan",
                [_P] * 12 + [_L, _I, _L, _I, _I, _P])
BLOCK = Kernel("cc_fused", "cc_fused_scan_batched_block",
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
GRID = Kernel("cc_fused", "cc_fused_scan_batched",
              [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
BATCHED = Bodies(BLOCK, GRID)
# the block body keeps a graph's two pi buffers, 8 B a vertex, in one
# block's shared memory: 128 KB at 16,384 of the 227 KB a block can have
BLOCK_MAX_V_PAD = 16384
_INT32_LIMIT = 2**31


def batched_body(v_pad: int) -> str:
    """The body a CUDA bucket of graphs of ``v_pad`` vertices takes:
    ``"block"`` (one graph a block, pi in shared memory) up to
    ``BLOCK_MAX_V_PAD``, ``"grid"`` (the whole bucket stepping together,
    pi in device memory) above it."""
    return "block" if v_pad <= BLOCK_MAX_V_PAD else "grid"


def fused_segment_scan(pi: torch.Tensor, segments: torch.Tensor,
                       true_counts: torch.Tensor, *, lift_steps: int = 2,
                       fuel: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Fig. 4 segment scan in ONE kernel launch.

    Args:
      pi: int32 [V] parent workspace (not modified).
      segments: int32 [S, seg, 2] edge segments (pad tail with (0, 0)).
      true_counts: int32 [S] per-segment true edge counts; slots past
        them are masked to (0, 0) no-ops.
      fuel: compress fuel per segment; None derives ``compress_fuel(V)``.

    Returns:
      (pi', sweeps int32 [S]) — sweeps feed jump billing outside.
      A CPU ``pi`` runs the plain version; a CUDA one the kernel.
    """
    if fuel is None:
        fuel = compress_fuel(pi.shape[0])
    true_counts = true_counts.to(torch.int32)
    if pi.device.type == "cpu":
        return ref_segment_scan(pi, segments, true_counts,
                                lift_steps=lift_steps, fuel=fuel)
    check_int32("pi", pi, 1)
    check_int32("segments", segments, 3)
    check_int32("true_counts", true_counts, 1)
    num_segments, seg, two = segments.shape
    if two != 2 or true_counts.shape[0] != num_segments:
        raise ValueError(f"segments {tuple(segments.shape)} and true_counts "
                         f"{tuple(true_counts.shape)} do not match")
    if not (segments.device == pi.device == true_counts.device):
        raise ValueError("pi, segments and true_counts must share a device")
    out = pi.clone()
    sweeps = torch.zeros(num_segments, dtype=torch.int32, device=pi.device)
    if pi.shape[0] == 0 or num_segments == 0 or seg == 0:
        return out, sweeps
    scratch = torch.empty_like(pi)
    hilo = torch.empty((seg, 2), dtype=torch.int32, device=pi.device)
    flags = torch.zeros(num_segments * fuel, dtype=torch.int32,
                        device=pi.device)
    with torch.cuda.device(pi.device):
        KERNEL.launch(segments.data_ptr(), true_counts.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), hilo.data_ptr(),
                      flags.data_ptr(), sweeps.data_ptr(), pi.shape[0],
                      num_segments, seg, lift_steps, fuel, stream_of(pi))
    return out, sweeps


def fused_forest_scan(pi: torch.Tensor, parents: torch.Tensor,
                      parent_eidx: torch.Tensor, edges: torch.Tensor,
                      edge_ids: torch.Tensor, true_counts: torch.Tensor, *,
                      segment_size: int, lift_steps: int, fuel: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The id-recording segment scan in ONE kernel launch.

    Args:
      pi: int32 [V] parent workspace (not modified).
      parents, parent_eidx: int32 [V, 2] and [V] forest tables; each
        root a hook retires takes its winning row's edge and id, in
        place.
      edges, edge_ids: int32 [R, 2] and [R]: segment i is rows
        ``i * segment_size`` onwards, of which only the first
        ``true_counts[i]`` are hooked.
      true_counts: int [S] on the CPU (the sizes the host planned), each
        at most ``segment_size`` and within R (``ValueError``
        otherwise).
      fuel: compress fuel per segment.

    Returns:
      (pi', sweeps int32 [S]), equal to ``ref_forest_scan``'s, tables
      included. A CPU ``pi`` runs that plain version; a CUDA one the
      kernel.
    """
    true_counts = true_counts.to(torch.int32)
    starts = torch.arange(true_counts.shape[0]) * segment_size
    if true_counts.device.type != "cpu" or segment_size < 1 or (
            true_counts.numel() and (
                int(true_counts.min()) < 0
                or int(true_counts.max()) > segment_size
                or int((starts + true_counts).max()) > edges.shape[0])):
        raise ValueError(f"true_counts must be host counts in [0, "
                         f"{segment_size}] within {edges.shape[0]} rows")
    if pi.device.type == "cpu":
        return ref_forest_scan(pi, parents, parent_eidx, edges, edge_ids,
                               true_counts, segment_size=segment_size,
                               lift_steps=lift_steps, fuel=fuel)
    n = pi.shape[0]
    for name, t, ndim in (("pi", pi, 1), ("parents", parents, 2),
                          ("parent_eidx", parent_eidx, 1),
                          ("edges", edges, 2), ("edge_ids", edge_ids, 1)):
        check_int32(name, t, ndim)
    num_segments = true_counts.shape[0]
    if parents.shape != (n, 2) or parent_eidx.shape != (n,) \
            or edges.shape[1:] != (2,) or edge_ids.shape != edges.shape[:1]:
        raise ValueError(f"pi {tuple(pi.shape)}, parents "
                         f"{tuple(parents.shape)}, parent_eidx "
                         f"{tuple(parent_eidx.shape)}, edges "
                         f"{tuple(edges.shape)} and edge_ids "
                         f"{tuple(edge_ids.shape)} do not match")
    if len({t.device for t in (pi, parents, parent_eidx, edges,
                               edge_ids)}) != 1:
        raise ValueError("pi, the tables and the edges must share a "
                         "device")
    out = pi.clone()
    sweeps = torch.zeros(num_segments, dtype=torch.int32, device=pi.device)
    if n == 0 or num_segments == 0:
        return out, sweeps
    scratch = torch.empty_like(pi)
    hilo = torch.empty((2 * segment_size, 2), dtype=torch.int32,
                       device=pi.device)
    winner = torch.full_like(pi, _INT32_LIMIT - 1)
    flags = torch.zeros(num_segments * (fuel + 1), dtype=torch.int32,
                        device=pi.device)
    landed = flags[num_segments * fuel:]
    counts = true_counts.to(pi.device)
    with torch.cuda.device(pi.device):
        FOREST.launch(edges.data_ptr(), edge_ids.data_ptr(),
                      counts.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), hilo.data_ptr(), winner.data_ptr(),
                      parents.data_ptr(), parent_eidx.data_ptr(),
                      flags.data_ptr(), landed.data_ptr(), sweeps.data_ptr(),
                      n, num_segments, segment_size, lift_steps, fuel,
                      stream_of(pi))
    return out, sweeps


def check_batch_extent(batch: int, v_pad: int, seg: int) -> None:
    """Raise ``ValueError`` unless a bucket of ``batch`` graphs of
    ``v_pad`` vertices (a power of two) and ``seg`` edge slots a segment
    indexes within int32: the batched kernel addresses pi and its slots
    with 32-bit ids and must not wrap around."""
    if v_pad < 1 or v_pad & (v_pad - 1):
        raise ValueError(f"V_pad must be a power of two, got {v_pad}")
    for what, n in (("B * V_pad", batch * v_pad), ("B * seg", batch * seg)):
        if n >= _INT32_LIMIT:
            raise ValueError(f"{what} = {n} does not fit int32: split the "
                             "bucket")


def fused_segment_scan_batched(pi: torch.Tensor, segments: torch.Tensor,
                               true_counts: torch.Tensor, *,
                               lift_steps: int = 2, fuel: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The segment scan of a bucket of B same-shape graphs in ONE launch.

    Args:
      pi: int32 [B, V_pad] parent workspaces in LOCAL vertex ids, V_pad a
        power of two (not modified).
      segments: int32 [B, S, seg, 2] edge segments in local ids.
      true_counts: int32 [B, S] per-graph, per-segment true edge counts;
        slots past them are masked to (0, 0) no-ops.
      fuel: compress fuel per segment, the same for every graph; None
        derives ``compress_fuel(V_pad)``.

    Returns:
      (pi' [B, V_pad], sweeps int32 [B, S]): each graph's pi and sweeps
      equal ``fused_segment_scan`` on that graph alone. A CPU ``pi`` runs
      the plain version; a CUDA one the kernel, on the body that
      ``batched_body(V_pad)`` names. B * V_pad and B * seg must stay
      below 2^31 (``ValueError`` otherwise).
    """
    if pi.dim() != 2 or segments.dim() != 4 or true_counts.dim() != 2:
        raise ValueError(f"pi {tuple(pi.shape)}, segments "
                         f"{tuple(segments.shape)} and true_counts "
                         f"{tuple(true_counts.shape)} must be [B, V_pad], "
                         "[B, S, seg, 2] and [B, S]")
    batch, v_pad = pi.shape
    _, num_segments, seg, two = segments.shape
    if two != 2 or segments.shape[0] != batch \
            or tuple(true_counts.shape) != (batch, num_segments):
        raise ValueError(f"segments {tuple(segments.shape)} and true_counts "
                         f"{tuple(true_counts.shape)} do not match pi "
                         f"{tuple(pi.shape)}")
    check_batch_extent(batch, v_pad, seg)
    if fuel is None:
        fuel = compress_fuel(v_pad)
    true_counts = true_counts.to(torch.int32)
    if pi.device.type == "cpu":
        return ref_segment_scan_batched(pi, segments, true_counts,
                                        lift_steps=lift_steps, fuel=fuel)
    check_int32("pi", pi, 2)
    check_int32("segments", segments, 4)
    check_int32("true_counts", true_counts, 2)
    if not (segments.device == pi.device == true_counts.device):
        raise ValueError("pi, segments and true_counts must share a device")
    if batch == 0 or num_segments == 0 or seg == 0:
        return pi.clone(), torch.zeros((batch, num_segments),
                                       dtype=torch.int32, device=pi.device)
    log2_vp = v_pad.bit_length() - 1
    if batched_body(v_pad) == "block":
        # the kernel reads pi and writes every entry of out and sweeps
        out = torch.empty_like(pi)
        sweeps = torch.empty((batch, num_segments), dtype=torch.int32,
                             device=pi.device)
        with torch.cuda.device(pi.device):
            BLOCK.launch(segments.data_ptr(), true_counts.data_ptr(),
                         pi.data_ptr(), out.data_ptr(), sweeps.data_ptr(),
                         batch, log2_vp, num_segments, seg, lift_steps, fuel,
                         stream_of(pi))
        return out, sweeps
    out = pi.clone()
    sweeps = torch.empty((batch, num_segments), dtype=torch.int32,
                         device=pi.device)
    scratch = torch.empty_like(pi)
    hilo = torch.empty((batch * seg, 2), dtype=torch.int32, device=pi.device)
    flags = torch.zeros(num_segments * fuel * (batch + 1), dtype=torch.int32,
                        device=pi.device)
    any_flags = flags[num_segments * fuel * batch:]
    with torch.cuda.device(pi.device):
        GRID.launch(segments.data_ptr(), true_counts.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), hilo.data_ptr(),
                    flags.data_ptr(), any_flags.data_ptr(),
                    sweeps.data_ptr(), batch, log2_vp, num_segments, seg,
                    lift_steps, fuel, stream_of(pi))
    return out, sweeps
