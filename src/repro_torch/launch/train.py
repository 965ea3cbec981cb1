"""End-to-end training launcher, the port of ``repro.launch.train``:
``--arch <id>`` on that architecture's smoke config.

Assembles the train step of ``launch.steps``' cells with the real
substrate: the deterministic data pipeline (+ prefetch), async atomic
checkpoints, restart on failure and the step-time watchdog. It runs on
CUDA unless ``--device`` names another device (``--device cpu``), and
raises without CUDA otherwise.

Only the recsys family trains so far; the LM and GNN families raise
``NotImplementedError`` (ROADMAP A11.3 and A11.4).

Examples:
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

_NOT_PORTED = {
    "lm": "LM training is not ported yet (ROADMAP A11.3)",
    "gnn": "GNN training is not ported yet (ROADMAP A11.4)",
}


def _model_api(arch_id: str):
    """The model module of ``arch_id``'s family."""
    mod = get_arch(arch_id)    # raises for the GNN ids, naming A11.4
    if mod.FAMILY != "recsys":
        raise NotImplementedError(f"{arch_id}: {_NOT_PORTED[mod.FAMILY]}")
    from repro_torch.models import recsys as M
    return M


def _smoke_stream(cfg, seed: int, batch: int):
    """(start_step -> iterator) of recsys batches, smoke-sized."""
    def make(start):
        return dp.make_stream(dp.recsys_batches, seed, batch, cfg.n_dense,
                              cfg.table_sizes, start_step=start)
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
    cfg = get_arch(args.arch).make_smoke_config()
    dev = resolve_device(args.device)
    opt = adamw(AdamWConfig(
        lr=cosine_schedule(args.lr, warmup=10, total=args.steps)))
    raw_step = train_state.make_train_step(M.loss_fn, opt)
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
            stream_fn=_smoke_stream(cfg, args.seed, args.batch),
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
