"""The gradients of the two recsys kernels, which pair them: each one's
backward runs on the other.

* ``embedding_bag``: a lookup whose table requires grad (with grad mode
  on) goes through a ``torch.autograd.Function``. The forward is the
  embedding-bag kernel; the backward to the table is ``table_grad``,
  the segment sum of the output-gradient rows by row id into
  [Vocab, D] on the segment-reduce kernel's sorted body. The indices
  get no gradient.
* ``segment_reduce``: a sum whose data requires grad goes through a
  Function whose backward gathers ``grad_out[ids]`` (``gather_rows``:
  the embedding-bag kernel with bags of 1; 0 for a dropped row). The
  ids get no gradient, and a gradient through ``min`` or ``max`` raises:
  the reference's models never take one.

Without a gradient to take, each call is the kernel wrapper's own. On
the CPU the wrappers run the plain versions, so the backward does too.
The reference has no custom VJP: it differentiates ``jnp.take`` (a
scatter-add in the table's dtype), so in bfloat16 the two differ by
their rounding (the port sums in fp32 and rounds once).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.segment_reduce import ops as sr_ops


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  combine: str = "sum") -> torch.Tensor:
    """``embedding_bag.ops.embedding_bag``, with a gradient to a table
    that requires grad (``table_grad``)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _EmbeddingBag.apply(table, indices, combine)
    return eb_ops.embedding_bag(table, indices, combine=combine)


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, op: str = "sum",
                   indices_are_sorted: bool = False) -> torch.Tensor:
    """``segment_reduce.ops.segment_reduce``, with a gradient to data
    that requires grad for ``sum`` (``gather_rows``)."""
    if data.requires_grad and torch.is_grad_enabled():
        if op != "sum":
            raise NotImplementedError(
                f"segment_reduce has no gradient through {op!r}, only "
                "through 'sum'")
        return _SegmentSum.apply(data, segment_ids, num_segments,
                                 indices_are_sorted)
    return sr_ops.segment_reduce(data, segment_ids, num_segments, op=op,
                                 indices_are_sorted=indices_are_sorted)


def table_grad(grad_out: torch.Tensor, indices: torch.Tensor, rows: int,
               combine: str = "sum") -> torch.Tensor:
    """The lookup's gradient to its [rows, D] table: each bag's output
    gradient row (``grad_out`` [B, D]; divided by ``bag`` first for
    ``mean``) added into each of the bag's rows, fp32 sums rounded once
    to the gradient's dtype. A stable sort of the flat ids puts each
    row's contributions next to each other in their original order; the
    embedding-bag kernel gathers the gradient rows in that order (bags
    of 1) and the segment-reduce kernel's sorted body sums them, so the
    result does not change from call to call."""
    bag = indices.shape[1]
    g = grad_out.contiguous()
    if combine == "mean":
        g = g / bag
    ids, order = torch.sort(indices.reshape(-1), stable=True)
    src = torch.div(order, bag, rounding_mode="floor").to(torch.int32)
    return sr_ops.segment_reduce(eb_ops.embedding_bag(g, src[:, None]), ids,
                                 rows, indices_are_sorted=True)


def gather_rows(grad_out: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The segment sum's gradient to its data: ``grad_out[ids]`` ([S, D]
    or [S] -> [N, D] or [N]), 0 for a row whose id lies outside [0, S),
    gathered by the embedding-bag kernel (bags of 1)."""
    squeeze = grad_out.dim() == 1
    g = (grad_out[:, None] if squeeze else grad_out).contiguous()
    n = segment_ids.shape[0]
    if num_segments == 0:
        rows = g.new_zeros((n, g.shape[1]))
    else:
        keep = (segment_ids >= 0) & (segment_ids < num_segments)
        ids = torch.where(keep, segment_ids, 0).to(torch.int32)
        rows = torch.where(keep[:, None],
                           eb_ops.embedding_bag(g, ids[:, None]),
                           g.new_zeros(()))
    return rows[:, 0] if squeeze else rows


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, combine):
        ctx.save_for_backward(indices)
        ctx.rows, ctx.combine = table.shape[0], combine
        return eb_ops.embedding_bag(table, indices, combine=combine)

    @staticmethod
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        return table_grad(grad_out, indices, ctx.rows, ctx.combine), \
            None, None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, indices_are_sorted):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return sr_ops.segment_reduce(data, segment_ids, num_segments,
                                     indices_are_sorted=indices_are_sorted)

    @staticmethod
    def backward(ctx, grad_out):
        (segment_ids,) = ctx.saved_tensors
        return gather_rows(grad_out, segment_ids, ctx.num_segments), \
            None, None, None
