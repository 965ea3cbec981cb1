"""Per-(arch × shape) step builders, the port of ``repro.launch.steps``
for the recsys family (training and serving), the LM train and serving
steps, the GNN train steps and the paper's multi-shard CC on the Table
I graphs.

``build_cell(arch_id, shape, device=...)`` returns a ``Cell``: the step
callable and the ``(shape, dtype)`` specs of its arguments. Building a
cell allocates nothing. A step takes the model and host (numpy) inputs,
moves the inputs to the cell's device and runs there:

  * ``train``     — ``step(state, batch)`` -> (state, {"loss",
                    "grad_norm"}): one AdamW step on a
                    ``train.train_state`` state, written in place;
                    ``cell.init_state(model)`` makes that state over a
                    trainable model. Recsys: lr 1e-3, as the
                    reference's ``_build_recsys`` sets it. LM: lr 3e-4,
                    the arch's ``MOMENT_DTYPE`` (None: the parameter's
                    dtype) for the moments and the gradient
                    accumulator, ``ACCUM_STEPS`` microbatches (4 unless
                    the arch sets it), weight decay on every layer's
                    leaf (``transformer.decays``), as the reference's
                    ``_build_lm``. GNN: lr 1e-3 on the config of the
                    shape (``make_config(shape)``), the default decay
                    of every leaf with ``ndim >= 2`` (the layers are
                    stacked as in the reference), as its ``_build_gnn``;
  * ``serve``     — ``step(model, batch)`` -> logits [B];
  * ``retrieval`` — ``step(model, batch, candidate_ids)`` -> scores [N];
  * ``prefill``   — ``step(params, tokens, cache)`` -> (logits [B, S, V],
                    cache): the prompt pass over ``tokens`` [B, S];
  * ``decode``    — ``step(params, tokens, positions, cache)`` ->
                    (logits [B, 1, V], cache): one token per request at
                    ``positions`` [B];
  * ``cc``        — ``step(edges)`` -> labels [V]: the multi-shard
                    engine (``core.distributed``) over the cell's mesh on
                    host edges of up to the spec's rows, padded with
                    (0, 0) no-ops to ``per * n_shards`` rows.

The cache is a device tree (``transformer.init_cache``), updated in
place.

No shardings: the model cells run on one device, and the train step's
in-place update stands in for donation. The ``cc`` cell splits its
edges over a ``launch.mesh.Mesh`` of slots (one slot on the device when
no mesh is given).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import resolve_device
from repro_torch.models import recsys
from repro_torch.models import transformer as T
from repro_torch.models.gnn import model_of
from repro_torch.train import train_state
from repro_torch.train.optimizer import AdamWConfig, adamw


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple                    # (shape, dtype) spec trees
    init_state: Callable | None = None     # train: model -> TrainState


def _on(x, device: torch.device) -> torch.Tensor:
    """A host array, or a tensor, on ``device`` (a tensor already there
    is not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def _batch_on(batch: dict, device: torch.device) -> dict:
    return {k: _on(v, device) for k, v in batch.items()}


def _build_recsys(arch_id: str, shape: str, device: torch.device) -> Cell:
    mod = get_arch(arch_id)
    kind = mod.step_kind(shape)
    cfg = mod.make_config()
    specs = mod.input_specs(shape)
    params = {n: (s, cfg.dtype)
              for n, s in recsys.param_shapes(cfg).items()}
    if kind == "train":
        opt = adamw(AdamWConfig(lr=1e-3))
        raw = train_state.make_train_step(recsys.loss_fn, opt)

        def step(state, batch):
            return raw(state, _batch_on(batch, device))
        state = {"params": params, "opt": {"m": params, "v": params},
                 "step": ((), torch.int32)}
        return Cell(arch_id, shape, kind, step,
                    args=(state, specs["batch"]),
                    init_state=lambda model: train_state.create(model, opt))
    if kind == "serve":
        def step(model, batch):
            return recsys.forward(model, _batch_on(batch, device))
        return Cell(arch_id, shape, kind, step,
                    args=(params, specs["batch"]))

    def step(model, batch, candidate_ids):
        return recsys.retrieval_scores(model, _batch_on(batch, device),
                                       _on(candidate_ids, device))
    return Cell(arch_id, shape, kind, step,
                args=(params, specs["batch"], specs["candidate_ids"]))


def _build_lm(arch_id: str, shape: str, device: torch.device) -> Cell:
    mod = get_arch(arch_id)
    kind = mod.step_kind(shape)
    cfg = mod.make_config()
    specs = mod.input_specs(shape)
    params = T.param_specs(cfg)
    if kind == "train":
        moment_dtype = getattr(mod, "MOMENT_DTYPE", None)
        opt = adamw(AdamWConfig(lr=3e-4, moment_dtype=moment_dtype,
                                decays=T.decays))
        raw = train_state.make_train_step(
            lambda model, batch: T.loss_fn(model, batch, cfg), opt,
            accum_steps=getattr(mod, "ACCUM_STEPS", 4),
            accum_dtype=moment_dtype)

        def step(state, batch):
            return raw(state, _batch_on(batch, device))
        moments = {n: (s, moment_dtype or dt) for n, (s, dt) in
                   params.items()}
        state = {"params": params, "opt": {"m": moments, "v": moments},
                 "step": ((), torch.int32)}
        return Cell(arch_id, shape, kind, step,
                    args=(state, specs["batch"]),
                    init_state=lambda model: train_state.create(model, opt))
    if kind == "prefill":
        def step(model, tokens, cache):
            tokens = _on(tokens, device)
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=device)
            return T.forward_with_cache(model, tokens, cfg, cache,
                                        positions)
        return Cell(arch_id, shape, kind, step,
                    args=(params, specs["tokens"], specs["cache"]))

    def step(model, tokens, positions, cache):
        return T.forward_with_cache(model, _on(tokens, device)[:, None], cfg,
                                    cache, _on(positions, device)[:, None])
    return Cell(arch_id, shape, kind, step,
                args=(params, specs["tokens"], specs["positions"],
                      specs["cache"]))


def _build_gnn(arch_id: str, shape: str, device: torch.device) -> Cell:
    """A GNN train cell: NequIP too takes this plain step (the
    reference's ``shard_map`` step over a mesh has no one-device
    analogue)."""
    mod = get_arch(arch_id)
    M = model_of(arch_id)
    cfg = mod.make_config(shape)
    specs = mod.input_specs(shape)
    params = {n: (s, cfg.dtype) for n, s in M.param_shapes(cfg).items()}
    opt = adamw(AdamWConfig(lr=1e-3))
    raw = train_state.make_train_step(
        lambda model, batch: M.loss_fn(model, batch, cfg), opt)

    def step(state, batch):
        return raw(state, _batch_on(batch, device))
    state = {"params": params, "opt": {"m": params, "v": params},
             "step": ((), torch.int32)}
    return Cell(arch_id, shape, "train", step, args=(state, specs["batch"]),
                init_state=lambda model: train_state.create(model, opt))


def _build_cc(shape: str, mesh) -> Cell:
    """The paper's multi-shard CC on a Table I graph (full size). The
    engine is built on a ``meta`` edge tensor: nothing is allocated
    until the step runs."""
    from repro_torch.configs import cc_graphs
    # the engine is built on a meta edge tensor, which the Solver facade
    # (concrete graphs only) cannot take  # analysis: ok[kernel-ast]
    from repro_torch.core.distributed import build_distributed_cc
    from repro_torch.graphs.device import DeviceGraph

    specs = cc_graphs.input_specs(shape)
    n_shards = len(mesh.slot_devices(("data",)))
    e, v = specs["edges"][0][0], specs["num_nodes"]
    per = (e + n_shards - 1) // n_shards
    rows = per * n_shards
    abstract = DeviceGraph(
        torch.empty((rows, 2), dtype=torch.int32, device="meta"), v, e,
        plan_segmentation(rows, v))
    fn = build_distributed_cc(abstract, mesh, axis_names=("data",))
    slot0 = fn.slots[0]

    def step(edges):
        edges = torch.as_tensor(np.asarray(edges, np.int32)).reshape(-1, 2)
        if edges.shape[0] > rows:
            raise ValueError(f"{shape}: {edges.shape[0]} edges exceed the "
                             f"cell's {rows} rows")
        padded = torch.zeros((rows, 2), dtype=torch.int32, device=slot0)
        padded[:edges.shape[0]] = edges.to(slot0)
        return fn.on_edges(padded)
    step.engine = fn
    return Cell("cc-adaptive", shape, "cc", step,
                args=(((rows, 2), torch.int32),))


def build_cell(arch_id: str, shape: str, *, device=None, mesh=None) -> Cell:
    """The cell of ``(arch_id, shape)`` on ``device`` (CUDA unless
    given; raises without CUDA unless ``device="cpu"``). ``mesh`` (a
    ``launch.mesh.Mesh``) is where the ``cc-adaptive`` cell splits its
    edges; the model cells take none."""
    if arch_id == "cc-adaptive":
        if mesh is None:
            from repro_torch.launch.mesh import Mesh
            mesh = Mesh([resolve_device(device)], ("data",))
        return _build_cc(shape, mesh)
    if mesh is not None:
        raise ValueError(f"{arch_id} runs on one device; mesh= is for the "
                         "cc-adaptive cell")
    device = resolve_device(device)
    family = get_arch(arch_id).FAMILY
    if family == "lm":
        return _build_lm(arch_id, shape, device)
    if family == "gnn":
        return _build_gnn(arch_id, shape, device)
    return _build_recsys(arch_id, shape, device)
