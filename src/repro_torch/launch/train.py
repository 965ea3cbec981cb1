"""End-to-end training launcher, the port of ``repro.launch.train``:
``--arch <id>`` on that architecture's smoke config.

Assembles the train step of ``launch.steps``' cells with the real
substrate: the deterministic data pipeline (+ prefetch), async atomic
checkpoints, restart on failure and the step-time watchdog. It runs on
CUDA unless ``--device`` names another device (``--device cpu``), and
raises without CUDA otherwise.

The recsys, LM and GNN families train: an LM on 32-token sequences,
DCN-v2 on recsys batches, NequIP on 8 molecules of 8 atoms and 12
bonds, the other GNNs on a 64-node, 128-edge graph (GatedGCN with edge
features, GIN with 8 graph labels), as the reference's smoke streams.

Examples:
  python -m repro_torch.launch.train --arch gemma2-2b --steps 100
  python -m repro_torch.launch.train --arch gin-tu --steps 50 --fail-at 20
  python -m repro_torch.launch.train --arch dcn-v2 --steps 200
  python -m repro_torch.launch.train --arch dcn-v2 --steps 30 \\
      --fail-at 15 --ckpt build/ck_dcn
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.graphs.device import resolve_device
from repro_torch.train import train_state
from repro_torch.train.fault_tolerance import (SimulatedFailure, StepWatchdog,
                                               run_with_restarts)
from repro_torch.train.optimizer import AdamWConfig, adamw, cosine_schedule

def _model_api(arch_id: str):
    """The model module of ``arch_id``'s family."""
    family = get_arch(arch_id).FAMILY
    if family == "lm":
        from repro_torch.models import transformer as M
        return M
    if family == "gnn":
        from repro_torch.models.gnn import model_of
        return model_of(arch_id)
    from repro_torch.models import recsys as M
    return M


def _gnn_batch(arch_id: str, cfg, seed: int, step: int) -> dict:
    """Batch ``step`` of a GNN's smoke stream (the reference's)."""
    if arch_id == "nequip":
        return dp.molecule_energy_batch(seed, step, num_graphs=8,
                                        nodes_per=8, edges_per=12,
                                        n_species=cfg.n_species)
    b = dp.graph_node_batch(seed, step, num_nodes=64, num_edges=128,
                            d_feat=cfg.d_in, n_classes=cfg.n_classes)
    if arch_id == "gatedgcn":
        rng = np.random.default_rng((seed, step, 1))
        b["edge_attr"] = rng.standard_normal(
            (b["src"].shape[0], cfg.d_edge_in)).astype(np.float32)
    if arch_id == "gin-tu" and cfg.graph_level:
        b["graph_ids"] = (np.arange(64) % cfg.num_graphs).astype(np.int32)
        rng = np.random.default_rng((seed, step, 2))
        b["y"] = rng.integers(0, cfg.n_classes,
                              cfg.num_graphs).astype(np.int32)
    return b


def _smoke_stream(arch_id: str, cfg, seed: int, batch: int):
    """(start_step -> iterator) of the arch's batches, smoke-sized."""
    family = get_arch(arch_id).FAMILY

    def make(start):
        if family == "lm":
            return dp.make_stream(dp.lm_batches, seed, batch, 32, cfg.vocab,
                                  start_step=start)
        if family == "recsys":
            return dp.make_stream(dp.recsys_batches, seed, batch,
                                  cfg.n_dense, cfg.table_sizes,
                                  start_step=start)

        def gen():
            step = start
            while True:
                yield _gnn_batch(arch_id, cfg, seed, step)
                step += 1
        return dp.Prefetcher(gen())
    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "deleted at the end)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a SimulatedFailure at this step (tests "
                         "the restart path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    M = _model_api(args.arch)
    family = get_arch(args.arch).FAMILY
    cfg = get_arch(args.arch).make_smoke_config()
    dev = resolve_device(args.device)
    lr = cosine_schedule(args.lr, warmup=10, total=args.steps)
    if family == "recsys":
        loss, opt = M.loss_fn, adamw(AdamWConfig(lr=lr))
    else:
        # the GNNs keep the reference's stacked layout: the default rule
        opt = adamw(AdamWConfig(lr=lr, decays=getattr(M, "decays", None)))

        def loss(params, batch):
            return M.loss_fn(params, batch, cfg)
    raw_step = train_state.make_train_step(loss, opt)
    failed = {"done": False}

    def step_fn(state, batch):
        s = int(state["step"])
        if args.fail_at and s == args.fail_at and not failed["done"]:
            failed["done"] = True
            raise SimulatedFailure(f"injected failure at step {s}")
        return raw_step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})

    def init_state():
        model = M.init(cfg, generator=torch.Generator(dev).manual_seed(
            args.seed), device=dev, requires_grad=True)
        return train_state.create(model, opt)

    losses = []
    with tempfile.TemporaryDirectory(prefix=f"ck_{args.arch}_") as tmp:
        report = run_with_restarts(
            init_state_fn=init_state,
            step_fn=step_fn,
            stream_fn=_smoke_stream(args.arch, cfg, args.seed, args.batch),
            total_steps=args.steps,
            ckpt_dir=args.ckpt or tmp,
            ckpt_every=args.ckpt_every,
            watchdog=StepWatchdog(),
            on_metrics=lambda s, m: losses.append((s, float(m["loss"]))),
        )
    first = np.mean([v for _, v in losses[:10]])
    last = np.mean([v for _, v in losses[-10:]])
    print(f"[train] {args.arch} on {dev}: {report.steps_run} steps, "
          f"{report.restarts} restarts, loss {first:.4f} -> {last:.4f}, "
          f"slow steps flagged: {len(report.slow_steps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
