"""Collectives over a ``Mesh``'s slots: the port of the ``jax.lax``
collectives the reference calls inside ``shard_map`` (``all_gather``,
``psum``, ``psum_scatter``, ``pmax``, ``pmean``).

The port runs every slot's work from one host process, as the
multi-shard CC engine does (``core.distributed``). A collective takes a
list of per-slot tensors, one a slot in ``mesh.slot_devices(axes)``
order, and returns one such list: what each slot holds after the
reference's collective. All have the reference's ``tiled=True``
semantics:

  * ``all_gather``   — the slots' tensors concatenated on axis 0;
  * ``psum``         — their sum;
  * ``psum_scatter`` — their sum, slot i given the i-th of k contiguous
                       blocks of axis 0;
  * ``pmax``         — their elementwise max;
  * ``pmean``        — their sum over the slot count.

On one device these are ``cat``, a sum and ``split``. Across devices
the slots' tensors are copied to slot 0's device, combined there, and
the result is copied back, as ``core.distributed.pmin`` merges. Slots
on one device share one result tensor. With one slot each returns its
input, and runs no op.

Each is differentiable by plain autograd: a result's backward adds the
cotangents of every slot's copy, so the backward of ``psum`` hands each
slot the sum of the cotangents once. A loss that every slot holds (the
reference's replicated loss) is therefore differentiated through one
slot's copy, which gives each input its true gradient. The reference's
transpose under ``shard_map(check_rep=False)`` sums the k copies'
cotangents instead, and its sharded NequIP gradient comes out k times
the single-device one (ROADMAP, reference-side).
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import _replicate


def _devices(xs) -> list:
    if not xs:
        raise ValueError("a collective needs at least one slot")
    return [x.device for x in xs]


def _reduce(xs, op) -> torch.Tensor:
    """``op`` folded over the slots in slot order, on slot 0's device."""
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(out.device))
    return out


def all_gather(xs) -> list[torch.Tensor]:
    """Every slot gets the slots' tensors concatenated on axis 0."""
    devices = _devices(xs)
    if len(xs) == 1:
        return [xs[0]]
    return _replicate(torch.cat([x.to(devices[0]) for x in xs]), devices)


def psum(xs) -> list[torch.Tensor]:
    """Every slot gets the sum of the slots' tensors."""
    devices = _devices(xs)
    if len(xs) == 1:
        return [xs[0]]
    return _replicate(_reduce(xs, torch.add), devices)


def psum_scatter(xs) -> list[torch.Tensor]:
    """Slot i gets the i-th of k contiguous blocks (axis 0) of the sum
    of the slots' tensors; axis 0 must divide by k."""
    devices = _devices(xs)
    k, n = len(xs), xs[0].shape[0]
    if n % k:
        raise ValueError(f"psum_scatter: axis 0 of size {n} does not "
                         f"split into {k} slots")
    if k == 1:
        return [xs[0]]
    blocks = _reduce(xs, torch.add).split(n // k)
    return [b.to(d) for b, d in zip(blocks, devices)]


def pmax(xs) -> list[torch.Tensor]:
    """Every slot gets the elementwise max of the slots' tensors."""
    devices = _devices(xs)
    if len(xs) == 1:
        return [xs[0]]
    return _replicate(_reduce(xs, torch.maximum), devices)


def pmean(xs) -> list[torch.Tensor]:
    """Every slot gets the sum of the slots' tensors over their count."""
    devices = _devices(xs)
    if len(xs) == 1:
        return [xs[0]]
    return _replicate(_reduce(xs, torch.add) / len(xs), devices)
