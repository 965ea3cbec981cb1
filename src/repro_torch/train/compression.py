"""Gradient compression, the port of ``repro.train.compression``: int8
uniform quantization with error feedback (EF-SGD, Karimireddy et al.).

Each worker quantizes (grad + residual), all-reduces the int8 payload,
dequantizes, and keeps the quantization error as next step's residual.

``compress`` / ``decompress`` / ``zero_residual`` are the transform pair
over name-keyed dicts of tensors (any tree that ``optimizer.named``
takes). ``compressed_psum`` is the same transform around a ``psum`` over
a mesh's slots (``launch.collectives``), the reference's inside
``shard_map``: every slot quantizes with one shared scale, the ``pmax``
of the slots' scales, the int8 payloads are summed in int32, and each
slot keeps its own residual.
"""
from __future__ import annotations

import torch

from repro_torch.launch import collectives
from repro_torch.train.optimizer import named


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp -> int8 with round-to-nearest-even; scale maps max|x| -> 127."""
    q = torch.round(x.float() / torch.clamp(scale, min=1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """max|x| / 127, correctly rounded: the divisor is a tensor on x's
    device, since CUDA divides by a Python scalar as a product with its
    rounded reciprocal, which can be one ulp off the reference's
    quotient."""
    return torch.max(torch.abs(x)) / torch.full((), 127.0,
                                                device=x.device)


def compress(grads, residual):
    """(grads + residual) -> (int8 payload, scales, new_residual)."""
    residual = named(residual)
    payload, scales, new_res = {}, {}, {}
    for n, g in named(grads).items():
        gf = g.float() + residual[n]
        scale = _scale(gf)
        q = _quantize(gf, scale)
        payload[n], scales[n] = q, scale
        new_res[n] = gf - q.float() * scale    # error feedback residual
    return payload, scales, new_res


def decompress(payload, scales, dtype_tree):
    dtypes = named(dtype_tree)
    return {n: (q.float() * scales[n]).to(dtypes[n].dtype)
            for n, q in named(payload).items()}


def zero_residual(params):
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}


def shared_payloads(grads, residual) -> tuple:
    """The int8 payloads ``compressed_psum`` sums: each slot's (grad +
    residual) in fp32, quantized with the shared scale (the ``pmax`` of
    the slots' max|x| / 127). ``grads`` and ``residual`` are lists, one
    tree a slot. Returns (payloads, scales, the fp32 sums), each a list
    of ``{name: tensor}`` a slot."""
    gs, rs = [named(g) for g in grads], [named(r) for r in residual]
    payloads, scales, sums = ([{} for _ in gs] for _ in range(3))
    for n in gs[0]:
        gf = [g[n].float() + r[n] for g, r in zip(gs, rs)]
        shared = collectives.pmax([_scale(x) for x in gf])
        for j, (x, s) in enumerate(zip(gf, shared)):
            payloads[j][n], scales[j][n], sums[j][n] = _quantize(x, s), s, x
    return payloads, scales, sums


def compressed_psum(grads, residual) -> tuple:
    """int8 EF all-reduce over a mesh's slots: ``grads`` and ``residual``
    lists, one tree a slot in ``mesh.slot_devices`` order. Returns (the
    mean-reduced grads, the new residuals), each a list of ``{name:
    tensor}`` a slot: the mean ``total * scale / n`` (the int32 total of
    the payloads, the shared scale, the slot count) in the gradient's
    dtype, and each slot's own error ``(grad + residual) - q * scale``.
    The scale is shared, so every slot dequantizes alike."""
    payloads, scales, sums = shared_payloads(grads, residual)
    gs = [named(g) for g in grads]
    means, new_res = [{} for _ in gs], [{} for _ in gs]
    for n in gs[0]:
        total = collectives.psum([q[n].to(torch.int32) for q in payloads])
        count = collectives.psum([torch.ones((), dtype=torch.int32,
                                             device=q[n].device)
                                  for q in payloads])
        for j, (t, c) in enumerate(zip(total, count)):
            s = scales[j][n]
            means[j][n] = (t.float() * s / c.float()).to(gs[j][n].dtype)
            new_res[j][n] = sums[j][n] - payloads[j][n].float() * s
    return means, new_res
