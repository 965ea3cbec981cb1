"""GatedGCN (Bresson & Laurent), edge-gated message passing with
residuals and edge-feature updates: the port of
``repro.models.gnn.gatedgcn``. Config: 16 layers, d_hidden=70
(benchmarking-GNNs setup).

The layers' leaves are stacked ``[L, ...]`` as in the reference; the
forward loops over them, each layer under ``checkpoint`` when
``cfg.remat`` (the reference's ``jax.checkpoint(nothing_saveable)``
over its scanned layer): only the layer's input (h, e) is kept, and
the backward runs the layer again.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import common as C

_LINEARS = ("U", "V", "A", "B", "Ce")


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str
    n_layers: int = 16
    d_in: int = 32
    d_edge_in: int = 8
    d_hidden: int = 70
    n_classes: int = 6
    remat: bool = True          # per-layer remat: the [E, d] edge states
                                # of all layers otherwise stay live
                                # through the backward
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: GatedGCNConfig) -> dict:
    L, d = cfg.n_layers, cfg.d_hidden
    out = {"embed_h.w": (cfg.d_in, d), "embed_h.b": (d,),
           "embed_e.w": (cfg.d_edge_in, d), "embed_e.b": (d,)}
    for k in _LINEARS:
        out[f"layers.{k}.w"], out[f"layers.{k}.b"] = (L, d, d), (L, d)
    out["layers.ln_h"] = out["layers.ln_e"] = (L, d)
    out["head.w"], out["head.b"] = (d, cfg.n_classes), (cfg.n_classes,)
    return out


def init(cfg: GatedGCNConfig, *, generator: torch.Generator | None = None,
         device=None, requires_grad: bool = False) -> dict:
    """Random parameters (as ``graphsage.init``), the layers' leaves
    stacked [L, ...]; LayerNorm weights 1."""
    g, dev = C.generator_and_device(generator, device)
    d = cfg.d_hidden
    layers = [{**{k: C.linear_params(d, d, cfg.dtype, **g) for k in _LINEARS},
               "ln_h": torch.ones((d,), dtype=cfg.dtype, device=dev),
               "ln_e": torch.ones((d,), dtype=cfg.dtype, device=dev)}
              for _ in range(cfg.n_layers)]
    stacked = {k: (torch.stack([lp[k] for lp in layers]) if k.startswith("ln")
                   else {p: torch.stack([lp[k][p] for lp in layers])
                         for p in ("w", "b")})
               for k in layers[0]}
    return C.trainable({
        "embed_h": C.linear_params(cfg.d_in, d, cfg.dtype, **g),
        "embed_e": C.linear_params(cfg.d_edge_in, d, cfg.dtype, **g),
        "layers": stacked,
        "head": C.linear_params(d, cfg.n_classes, cfg.dtype, **g),
    }, requires_grad)


def params_from_reference(tree: dict, cfg: GatedGCNConfig, *, device,
                          requires_grad: bool = False) -> dict:
    return C.params_from_reference(tree, param_shapes(cfg), cfg.dtype,
                                   device=device,
                                   requires_grad=requires_grad)


def state_from_reference(tree: dict, cfg: GatedGCNConfig, opt, *,
                         device) -> dict:
    return C.state_from_reference(
        params_from_reference(tree["params"], cfg, device=device,
                              requires_grad=True), tree, opt, device=device)


def _ln(x, g):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return g * (x - mu) * torch.rsqrt(var + 1e-5)


def _layer(lp: dict, h: torch.Tensor, e: torch.Tensor, src, dst):
    v = h.shape[0]
    e_new = (C.linear(lp["A"], h)[dst] + C.linear(lp["B"], h)[src]
             + C.linear(lp["Ce"], e))
    e = e + torch.relu(_ln(e_new, lp["ln_e"]))
    eta = torch.sigmoid(e)
    msg = eta * C.linear(lp["V"], h)[src]
    den = C.scatter_sum(eta, dst, v) + 1e-6
    agg = C.scatter_sum(msg, dst, v) / den
    h_new = C.linear(lp["U"], h) + agg
    return h + torch.relu(_ln(h_new, lp["ln_h"])), e


def forward(params: dict, batch: dict, cfg: GatedGCNConfig) -> torch.Tensor:
    src, dst = batch["src"], batch["dst"]
    h = C.linear(params["embed_h"], batch["x"].to(cfg.dtype))
    e = C.linear(params["embed_e"], batch["edge_attr"].to(cfg.dtype))
    for i in range(cfg.n_layers):
        lp = C.tree_map(lambda t: t[i], params["layers"])
        if cfg.remat:
            h, e = checkpoint(_layer, lp, h, e, src, dst, use_reentrant=False)
        else:
            h, e = _layer(lp, h, e, src, dst)
    return C.linear(params["head"], h)


def loss_fn(params: dict, batch: dict, cfg: GatedGCNConfig) -> torch.Tensor:
    return C.nll_loss(forward(params, batch, cfg), batch["y"],
                      batch.get("node_mask"))
