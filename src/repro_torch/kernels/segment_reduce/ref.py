"""Plain PyTorch version of the segment-reduce kernel."""
from __future__ import annotations

import math

import torch

OPS = ("sum", "min", "max")


def reduce_identity(op: str) -> float:
    """The value an empty segment holds: 0 for sum, +inf for min, -inf
    for max (``repro``'s ``reduce_identity`` for float dtypes)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    return {"sum": 0.0, "min": math.inf, "max": -math.inf}[op]


def ref_segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """``data`` [N, D] or [N], int ids [N] -> [S, D] or [S] in the data
    dtype, reduced in an fp32 buffer that starts at the identity. Rows
    whose id lies outside [0, S) are dropped, as ``jax.ops.segment_*``
    drops them."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    vals = data[keep].float()
    ids = ids[keep]
    acc = torch.full((num_segments, *data.shape[1:]), reduce_identity(op),
                     dtype=torch.float32, device=data.device)
    if op == "sum":
        acc.index_add_(0, ids, vals)
    else:
        index = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(vals)
        acc.scatter_reduce_(0, index, vals, "amin" if op == "min" else "amax")
    return acc.to(data.dtype)
