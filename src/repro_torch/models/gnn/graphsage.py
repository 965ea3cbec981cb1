"""GraphSAGE (mean aggregator), node classification: the port of
``repro.models.gnn.graphsage``.

Config: 2 layers, d_hidden=128, sample sizes 25-10 (the sampler lives
in ``repro_torch.graphs.sampler``; the model takes either a full graph
or the sampler's layered blocks, both edge lists).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: SAGEConfig) -> dict:
    """Every leaf's shape by dotted name (the reference tree's layout:
    ``layers`` a list of ``{w_self, w_neigh}`` linears, then ``head``)."""
    out, d_prev = {}, cfg.d_in
    for i in range(cfg.n_layers):
        for k in ("w_self", "w_neigh"):
            out[f"layers.{i}.{k}.w"] = (d_prev, cfg.d_hidden)
            out[f"layers.{i}.{k}.b"] = (cfg.d_hidden,)
        d_prev = cfg.d_hidden
    out["head.w"], out["head.b"] = (d_prev, cfg.n_classes), (cfg.n_classes,)
    return out


def init(cfg: SAGEConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> dict:
    """Random parameters on ``device`` (CUDA unless given): weights
    N(0, 1/fan_in), biases 0, drawn from ``generator`` (a generator of
    that device seeded 0 when None); trainable iff ``requires_grad``."""
    g, _ = C.generator_and_device(generator, device)
    layers, d_prev = [], cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({k: C.linear_params(d_prev, cfg.d_hidden, cfg.dtype,
                                          **g)
                       for k in ("w_self", "w_neigh")})
        d_prev = cfg.d_hidden
    return C.trainable({"layers": layers, "head": C.linear_params(
        d_prev, cfg.n_classes, cfg.dtype, **g)}, requires_grad)


def params_from_reference(tree: dict, cfg: SAGEConfig, *, device,
                          requires_grad: bool = False) -> dict:
    return C.params_from_reference(tree, param_shapes(cfg), cfg.dtype,
                                   device=device,
                                   requires_grad=requires_grad)


def state_from_reference(tree: dict, cfg: SAGEConfig, opt, *,
                         device) -> dict:
    return C.state_from_reference(
        params_from_reference(tree["params"], cfg, device=device,
                              requires_grad=True), tree, opt, device=device)


def _layer(lp: dict, x: torch.Tensor, src, dst) -> torch.Tensor:
    neigh = C.scatter_mean(x[src], dst, x.shape[0])
    x = torch.relu(C.linear(lp["w_self"], x) + C.linear(lp["w_neigh"], neigh))
    # L2 normalise (GraphSAGE §3.1)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def forward(params: dict, batch: dict, cfg: SAGEConfig) -> torch.Tensor:
    x = batch["x"].to(cfg.dtype)
    for lp in params["layers"]:
        x = _layer(lp, x, batch["src"], batch["dst"])
    return C.linear(params["head"], x)


def forward_sampled(params: dict, batch: dict, cfg: SAGEConfig
                    ) -> torch.Tensor:
    """Layered-block forward (DGL-style): layer i aggregates over the
    sampler's block-i edges (``src_i`` / ``dst_i``, local node ids into
    the shared frontier array). Seeds occupy the first rows; outputs are
    read through ``node_mask``."""
    x = batch["x"].to(cfg.dtype)
    for i, lp in enumerate(params["layers"]):
        x = _layer(lp, x, batch[f"src_{i}"], batch[f"dst_{i}"])
    return C.linear(params["head"], x)


def loss_fn(params: dict, batch: dict, cfg: SAGEConfig) -> torch.Tensor:
    fwd = forward_sampled if "src_0" in batch else forward
    return C.nll_loss(fwd(params, batch, cfg), batch["y"],
                      batch.get("node_mask"))
