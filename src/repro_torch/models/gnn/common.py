"""Shared GNN machinery, the port of ``repro.models.gnn.common``:
edge-index message passing through segment sums.

Message passing is gather(src) -> transform -> segment sum into dst.
Every sum goes through ``kernels.autograd.segment_reduce``: on a CUDA
tensor the segment-reduce kernel's atomic body (``dst`` is not sorted),
and, when the values require grad, a backward that gathers the output
gradient rows by ``dst`` on the embedding-bag kernel; on a CPU tensor
their plain versions. The edge gathers ``x[src]`` are torch indexing,
as the reference's are ``jnp`` gathers outside any kernel.

Every function takes a ``batch`` dict of tensors:

  src, dst   int32 [E]      (message edges; padded edges may point at a
                             dummy node masked via ``edge_mask``)
  x          float  [V, d]  node features
  edge_attr  float  [E, de] (optional)
  y          labels (node-level [V] or graph-level [G])
  graph_ids  int32 [V]      (block-diagonal batches; optional)
  node_mask  float [V]      (optional: valid nodes)

The tree helpers at the end carry a reference parameter tree (host
arrays) into the port, leaf for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.graphs.device import resolve_device
from repro_torch.kernels.autograd import segment_reduce
from repro_torch.models.layers import (from_numpy, normal_init,
                                      seeded_generator)


def scatter_sum(values: torch.Tensor, dst: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """Rows of ``values`` [E, ...] summed into [num_nodes, ...] by
    ``dst``; an id outside [0, num_nodes) is dropped."""
    return segment_reduce(values.contiguous(), dst, num_nodes)


def scatter_mean(values: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    s = scatter_sum(values, dst, num_nodes)
    deg = scatter_sum(values.new_ones((values.shape[0],)), dst, num_nodes)
    return s / torch.clamp(deg, min=1.0)[:, None]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` by ``jnp``'s rule for an index out of range: a
    negative index counts from the end, then the index is clamped; the
    gradient of an index outside [-n, n) is dropped, as ``jax.grad`` of
    the clamped gather drops it."""
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    rows = x[wrapped.clamp(0, n - 1)]
    inside = ((wrapped >= 0) & (wrapped < n)).view(-1, *[1] * (x.dim() - 1))
    return torch.where(inside, rows, rows.detach())


def scatter_softmax(scores: torch.Tensor, dst: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Edge softmax over incoming edges per destination node. The shift
    is the segment max of the detached scores: softmax does not move
    with it, so value and gradient are the reference's, whose gradient
    also flows through its ``segment_max``."""
    mx = segment_reduce(scores.detach().contiguous(), dst, num_nodes,
                        op="max")
    ex = torch.exp(scores - _take(mx, dst))
    den = scatter_sum(ex, dst, num_nodes)
    return ex / torch.clamp(_take(den, dst), min=1e-9)


def linear_params(din: int, dout: int, dtype: torch.dtype, *,
                  generator: torch.Generator, device=None,
                  bias: bool = True) -> dict:
    """``{"w": N(0, 1/din) [din, dout], "b": 0 [dout]}``."""
    p = {"w": normal_init((din, dout), din ** -0.5, dtype,
                          generator=generator, device=device)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def nll_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood in float32; with ``mask``, the
    masked mean ``sum / max(mask.sum(), 1)``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# --------------------------------------------------------------------------
# Parameter trees
# --------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` on every leaf of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def trainable(params: dict, requires_grad: bool) -> dict:
    if requires_grad:
        tree_map(lambda t: t.requires_grad_(True), params)
    return params


def generator_and_device(generator, device) -> tuple:
    dev = resolve_device(device)
    if generator is None:
        generator = seeded_generator(dev)
    return {"generator": generator, "device": dev}, dev


def params_from_reference(tree: dict, shapes: dict, dtype: torch.dtype, *,
                          device, requires_grad: bool) -> dict:
    """The reference's parameter tree (host arrays) as tensors on
    ``device``, the same layout; raises unless every leaf has the shape
    ``shapes`` names it with (dotted names, ``optimizer.named``) and
    ``dtype``."""
    from repro_torch.train.optimizer import named

    dev = resolve_device(device)
    params = tree_map(lambda a: from_numpy(a).to(dev), tree)
    got = {n: tuple(p.shape) for n, p in named(params).items()}
    if got != shapes:
        raise ValueError(f"parameter shapes {got} do not match the config's "
                         f"{shapes}")
    for n, p in named(params).items():
        if p.dtype != dtype:
            raise ValueError(f"{n} is {p.dtype}, the config says {dtype}")
    return trainable(params, requires_grad)


def state_from_reference(params: dict, tree: dict, opt, *, device) -> dict:
    """A port TrainState over ``params`` (the carried reference params)
    holding the reference TrainState ``tree``'s moments (keyed by
    parameter name) and step. Raises if a moment's shape or dtype
    differs from what ``opt`` makes for these parameters."""
    from repro_torch.train import train_state
    from repro_torch.train.optimizer import named

    dev = resolve_device(device)
    state = train_state.create(params, opt)
    if set(tree["opt"]) != set(state["opt"]):
        raise ValueError(f"optimizer state {sorted(tree['opt'])}, the "
                         f"optimizer makes {sorted(state['opt'])}")
    for key, want in state["opt"].items():
        got = named(tree_map(lambda a: from_numpy(a).to(dev),
                             tree["opt"][key]))
        for name, t in want.items():
            if got[name].shape != t.shape or got[name].dtype != t.dtype:
                raise ValueError(
                    f"opt.{key}.{name} is {tuple(got[name].shape)} "
                    f"{got[name].dtype}, the optimizer makes "
                    f"{tuple(t.shape)} {t.dtype}")
        state["opt"][key] = {name: got[name] for name in want}
    state["step"].fill_(int(tree["step"]))
    return state
