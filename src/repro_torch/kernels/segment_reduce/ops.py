"""Wrapper of the segment-reduce kernel (``csrc/segment_reduce.cu``).

The source holds two bodies, and ``indices_are_sorted`` picks one:

* ``True`` (ascending ids, ``jax.ops.segment_sum``'s contract) -> the
  sorted body ``segment_reduce_sorted``: one CUDA kernel that owns each
  output row, rows folded in order, sums deterministic;
* ``False`` -> the atomic body ``segment_reduce``: fill, atomics into an
  fp32 scratch, cast.

There is no fallback between them: a body that fails to build or launch
raises. Each body counts its own launches (``ATOMIC``, ``SORTED``);
``KERNEL.launches`` is their sum.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Bodies, Kernel, check_tensor, stream_of
from repro_torch.kernels.segment_reduce.ref import (OPS, ref_segment_reduce,
                                                    reduce_identity)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ATOMIC = Kernel("segment_reduce", "segment_reduce",
                [_P, _P, _P, _P, _L, _I, _L, _I, _I, _P])
SORTED = Kernel("segment_reduce", "segment_reduce_sorted",
                [_P, _P, _P, _L, _I, _L, _I, _I, _P])
KERNEL = Bodies(ATOMIC, SORTED)


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, op: str = "sum",
                   indices_are_sorted: bool = False) -> torch.Tensor:
    """Segment sum / min / max: ``data`` [N, D] or [N] (float32 or
    bfloat16) and int32 ids [N] give [S, D] or [S] in the data dtype;
    a segment no row reaches holds ``reduce_identity(op)`` and rows
    whose id lies outside [0, S) are dropped. The rows meet an fp32
    accumulator and are cast once at the end. ``indices_are_sorted``
    promises ascending ids, as ``jax.ops.segment_sum``'s argument of that
    name does. A CPU ``data`` runs the plain version and raises
    ``ValueError`` on a broken promise; a CUDA one the kernel body the
    flag names (one call, one counted launch) and, as jax does, leaves
    the promise to the caller (a check would cost a host sync): ids that
    are not ascending then give an unspecified result."""
    reduce_identity(op)                      # validates op
    if segment_ids.dim() != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_ids must be [N] with N = "
                         f"{data.shape[0]}, got {tuple(segment_ids.shape)}")
    if data.device.type == "cpu":
        if indices_are_sorted and not bool(
                (segment_ids[1:] >= segment_ids[:-1]).all()):
            raise ValueError("indices_are_sorted=True, but segment_ids "
                             "are not ascending")
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
    args = (n, d, num_segments, DTYPES[data.dtype], OPS.index(op),
            stream_of(data))
    # an int index keeps the guard's host cost (2 us) off a call whose
    # kernel runs for about 6 us at the embedding bag's shapes
    with torch.cuda.device(data.get_device()):
        if indices_are_sorted:
            SORTED.launch(rows.data_ptr(), segment_ids.data_ptr(),
                          out.data_ptr(), *args)
        else:
            acc = out if data.dtype == torch.float32 else torch.empty(
                (num_segments, d), dtype=torch.float32, device=data.device)
            ATOMIC.launch(rows.data_ptr(), segment_ids.data_ptr(),
                          acc.data_ptr(), out.data_ptr(), *args)
    return out[:, 0] if squeeze else out
