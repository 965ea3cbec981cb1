"""The gradients of the kernels that a training step runs through.
The two recsys kernels pair up: each one's backward runs on the other.

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

* ``flash_attention``: attention whose q, k or v requires grad goes
  through a Function whose forward is the flash-attention kernel and
  whose backward differentiates ``flash_attention.blocked``'s
  ``attention_blocked`` (torch ops; see ``_FlashAttention``).

Without a gradient to take, each call is the kernel wrapper's own. On
the CPU the wrappers run the plain versions, so the backward does too.
The reference has no custom VJP: it differentiates ``jnp.take`` (a
scatter-add in the table's dtype), so in bfloat16 the two differ by
their rounding (the port sums in fp32 and rounds once).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.blocked import attention_blocked
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """``flash_attention.ops.flash_attention``, with a gradient to q, k
    and v when one of them requires grad (``_FlashAttention``). Only
    causal attention has one: the backward's mask is causal."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not causal:
            raise NotImplementedError("flash_attention has a gradient only "
                                      "for causal attention")
        scale = float(sm_scale) if sm_scale is not None else \
            q.shape[-1] ** -0.5
        return _FlashAttention.apply(q, k, v, scale, int(window),
                                     float(softcap))
    return fa_ops.flash_attention(q, k, v, sm_scale=sm_scale, causal=causal,
                                  window=window, softcap=softcap)


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


class _FlashAttention(torch.autograd.Function):
    """Causal flash attention with a backward.

    The forward is the kernel wrapper's: on a CUDA tensor the
    flash-attention kernel (the Hopper body for bfloat16 at d = 64, 128,
    256, the FMA body otherwise), on a CPU one its plain version. It
    keeps q, k, v and the call's arguments.

    The backward runs ``attention_blocked`` again on detached q, k, v
    (positions 0.. on both sides, the same scale, window and softcap)
    under grad and takes ``torch.autograd.grad`` of it against the
    output's gradient: the blocked online-softmax recompute,
    differentiated, one kv block's score tile at a time. That is torch
    ops, not a kernel, because the reference has none to port: it
    defines no custom VJP and no backward Pallas kernel, and XLA
    differentiates its blocked attention outside any kernel. The forward
    output and the recompute differ by the forward's rounding (the
    Hopper body's P rounding, ``ref.p_rounding_bound``); the gradients
    are exactly those of ``attention_blocked``. The backward runs under
    the profiler range ``flash_attention_backward``.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, window, softcap)
        return fa_ops.flash_attention(q, k, v, sm_scale=scale, causal=True,
                                      window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, grad_out):
        scale, window, softcap = ctx.args
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        dev = q.device
        with torch.enable_grad(), \
                torch.profiler.record_function("flash_attention_backward"):
            out = attention_blocked(
                q, k, v,
                q_positions=torch.arange(q.shape[1], device=dev),
                k_positions=torch.arange(k.shape[1], device=dev),
                window=window, attn_softcap=softcap, scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None, None
