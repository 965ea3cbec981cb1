"""GIN (Graph Isomorphism Network) with learnable epsilon, graph or node
classification: the port of ``repro.models.gnn.gin``. Config: 5 layers,
d_hidden=64, sum aggregator, TU-dataset style graph classification on
molecule batches.

BatchNorm (the paper's choice) is LayerNorm here, as in the reference
(no cross-shard batch statistics): a weight, no bias, eps 1e-5 inside
the rsqrt.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_in: int = 16
    d_hidden: int = 64
    n_classes: int = 2
    graph_level: bool = True
    num_graphs: int = 128           # static graph count per batch
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: GINConfig) -> dict:
    out, d_prev, h = {}, cfg.d_in, cfg.d_hidden
    for i in range(cfg.n_layers):
        out[f"layers.{i}.eps"] = ()
        out[f"layers.{i}.mlp1.w"], out[f"layers.{i}.mlp1.b"] = (d_prev, h), \
            (h,)
        out[f"layers.{i}.mlp2.w"], out[f"layers.{i}.mlp2.b"] = (h, h), (h,)
        out[f"layers.{i}.ln"] = (h,)
        d_prev = h
    out["head.w"], out["head.b"] = (d_prev, cfg.n_classes), (cfg.n_classes,)
    return out


def init(cfg: GINConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> dict:
    """Random parameters (as ``graphsage.init``): eps 0, LayerNorm
    weights 1."""
    g, dev = C.generator_and_device(generator, device)
    layers, d_prev, h = [], cfg.d_in, cfg.d_hidden
    for _ in range(cfg.n_layers):
        layers.append({
            "eps": torch.zeros((), dtype=cfg.dtype, device=dev),
            "mlp1": C.linear_params(d_prev, h, cfg.dtype, **g),
            "mlp2": C.linear_params(h, h, cfg.dtype, **g),
            "ln": torch.ones((h,), dtype=cfg.dtype, device=dev),
        })
        d_prev = h
    return C.trainable({"layers": layers, "head": C.linear_params(
        d_prev, cfg.n_classes, cfg.dtype, **g)}, requires_grad)


def params_from_reference(tree: dict, cfg: GINConfig, *, device,
                          requires_grad: bool = False) -> dict:
    return C.params_from_reference(tree, param_shapes(cfg), cfg.dtype,
                                   device=device,
                                   requires_grad=requires_grad)


def state_from_reference(tree: dict, cfg: GINConfig, opt, *,
                         device) -> dict:
    return C.state_from_reference(
        params_from_reference(tree["params"], cfg, device=device,
                              requires_grad=True), tree, opt, device=device)


def forward(params: dict, batch: dict, cfg: GINConfig) -> torch.Tensor:
    x = batch["x"].to(cfg.dtype)
    src, dst = batch["src"], batch["dst"]
    v = x.shape[0]
    for lp in params["layers"]:
        h = (1.0 + lp["eps"]) * x + C.scatter_sum(x[src], dst, v)
        h = C.linear(lp["mlp2"], torch.relu(C.linear(lp["mlp1"], h)))
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        x = torch.relu(lp["ln"] * (h - mu) * torch.rsqrt(var + 1e-5))
    if cfg.graph_level:
        x = C.scatter_sum(x, batch["graph_ids"], cfg.num_graphs)
    return C.linear(params["head"], x)


def loss_fn(params: dict, batch: dict, cfg: GINConfig) -> torch.Tensor:
    return C.nll_loss(forward(params, batch, cfg), batch["y"])
