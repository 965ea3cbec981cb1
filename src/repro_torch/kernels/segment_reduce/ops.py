"""Wrapper of the segment-reduce kernel (``csrc/segment_reduce.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Kernel, check_tensor, stream_of
from repro_torch.kernels.segment_reduce.ref import (OPS, ref_segment_reduce,
                                                    reduce_identity)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL = Kernel("segment_reduce", "segment_reduce",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, op: str = "sum") -> torch.Tensor:
    """Segment sum / min / max: ``data`` [N, D] or [N] (float32 or
    bfloat16) and int32 ids [N] give [S, D] or [S] in the data dtype;
    a segment no row reaches holds ``reduce_identity(op)``. The rows
    meet an fp32 accumulator and are cast once at the end. A CPU
    ``data`` runs the plain version; a CUDA one the kernel (one call,
    one counted launch of the op)."""
    reduce_identity(op)                      # validates op
    if segment_ids.dim() != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_ids must be [N] with N = "
                         f"{data.shape[0]}, got {tuple(segment_ids.shape)}")
    if data.device.type == "cpu":
        return ref_segment_reduce(data, segment_ids, num_segments, op)
    squeeze = data.dim() == 1
    rows = data[:, None] if squeeze else data
    check_tensor("data", rows, tuple(DTYPES), 2)
    check_tensor("segment_ids", segment_ids, (torch.int32,), 1)
    if segment_ids.device != data.device:
        raise ValueError("segment_ids must be on data's device")
    n, d = rows.shape
    out = torch.empty((num_segments, d), dtype=data.dtype,
                      device=data.device)
    acc = out if data.dtype == torch.float32 else torch.empty(
        (num_segments, d), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        KERNEL.launch(rows.data_ptr(), segment_ids.data_ptr(),
                      acc.data_ptr(), out.data_ptr(), n, d, num_segments,
                      DTYPES[data.dtype], OPS.index(op), stream_of(data))
    return out[:, 0] if squeeze else out
