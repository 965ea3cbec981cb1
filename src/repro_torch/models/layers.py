"""Shared neural-net layers: the part of ``repro.models.layers`` that
the recsys model needs (initialisers and the plain MLP tower). Random
initialisation always draws from an explicit ``torch.Generator``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(shape, std: float, dtype: torch.dtype, *,
                generator: torch.Generator, device=None) -> torch.Tensor:
    """N(0, std²) drawn in float32, then cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def mlp_params(dims: list[int], dtype: torch.dtype, *,
               generator: torch.Generator, device=None) -> dict:
    """``{"ws": [W_i], "bs": [b_i]}`` for the layers ``dims[i] ->
    dims[i+1]``: W ~ N(0, 1/din), b = 0."""
    ws, bs = [], []
    for din, dout in zip(dims[:-1], dims[1:]):
        ws.append(normal_init((din, dout), din ** -0.5, dtype,
                              generator=generator, device=device))
        bs.append(torch.zeros((dout,), dtype=dtype, device=device))
    return {"ws": ws, "bs": bs}


def mlp_apply(params, x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Plain MLP tower: ``x @ W + b`` per layer, with ``act`` (relu or
    silu) between layers and none after the last."""
    n = len(params["ws"])
    for i, (w, b) in enumerate(zip(params["ws"], params["bs"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x) if act == "relu" else F.silu(x)
    return x
