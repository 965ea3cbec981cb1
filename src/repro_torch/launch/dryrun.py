"""Dry-run of every (architecture x input shape) cell on ``meta``
tensors, the port of ``repro.launch.dryrun``: build the cell, run one
step under the cost model (``roofline.analysis.cost``), print its
argument bytes and roofline, and append one JSONL record a cell.
Nothing is allocated and no card is needed.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all                # every cell
  python -m repro_torch.launch.dryrun --arch cc-adaptive --shape usa-osm
  python -m repro_torch.launch.dryrun --arch all --out dryrun.jsonl \\
      --skip-existing
  python -m repro_torch.launch.dryrun --arch all --jobs 7   # in parallel

The reference lowers and compiles each cell for 512 placeholder TPU
chips; the port runs it once on ``meta``, one card's worth, with no
``XLA_FLAGS``. ``--multi-pod`` fails every cell with
``make_production_mesh``'s message: a pod mesh has no one-card
analogue. A step that reads a value back to the host fails on ``meta``
(``Tensor.item()`` has nothing to read), as the reference fails to
compile one: such a cell fails the run. Exit codes as the
reference's: 0 when every cell that is not skipped passed, 1 otherwise.

The ``cc-adaptive`` cells read a convergence flag back every round, so
they cannot run on ``meta``: each is built on its ``meta`` path
(``launch.steps._build_cc``) and its record holds the state bytes and,
per round, the bound model's bytes of one hook pass (8 B an edge) and
one compress sweep (8 B a vertex), with ``model_flops`` 0 as in the
reference.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

MESH = "1xgpu"                     # one card: the record's mesh name


def _meta(spec):
    """A spec tree of ``(shape, dtype)`` leaves as ``meta`` tensors."""
    if isinstance(spec, tuple) and len(spec) == 2 \
            and isinstance(spec[1], torch.dtype):
        return torch.empty(spec[0], dtype=spec[1], device="meta")
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_meta(v) for v in spec]
    return spec


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    from repro_torch.train.optimizer import named
    if isinstance(tree, torch.nn.Module):
        tree = named(tree)
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _meta_model(arch: str, shape: str, train: bool):
    from repro_torch.configs import get_arch
    mod = get_arch(arch)
    if mod.FAMILY == "lm":
        from repro_torch.models import transformer
        return transformer.init(mod.make_config(), device="meta",
                                requires_grad=train)
    if mod.FAMILY == "recsys":
        from repro_torch.models import recsys
        return recsys.init(mod.make_config(), device="meta",
                           requires_grad=train)
    from repro_torch.models.gnn import model_of
    return model_of(arch).init(mod.make_config(shape), device="meta",
                               requires_grad=True)


def _model_flops(arch: str, shape: str) -> float:
    """Analytic MODEL_FLOPS for the cell (global, per step), the
    reference's."""
    from repro_torch.configs import get_arch
    if arch == "cc-adaptive":
        return 0.0
    mod = get_arch(arch)
    if mod.FAMILY == "lm":
        from repro_torch.configs.lm_common import SHAPE_DEFS
        from repro_torch.models.transformer import model_flops_per_token
        cfg = mod.make_config()
        d = SHAPE_DEFS[shape]
        f_tok = model_flops_per_token(cfg)
        if d["kind"] == "train":
            return f_tok * d["batch"] * d["seq"]
        if d["kind"] == "prefill":
            return f_tok / 3.0 * d["batch"] * d["seq"]   # fwd only: 2N
        return f_tok / 3.0 * d["batch"]                  # one token
    if mod.FAMILY == "recsys":
        from repro_torch.models import recsys as R
        cfg = mod.make_config()
        d = mod.SHAPE_DEFS[shape]
        dense_params = R.param_count(cfg) - cfg.total_rows * cfg.embed_dim
        mult = 6.0 if mod.step_kind(shape) == "train" else 2.0
        return mult * dense_params * d["batch"]
    return 0.0       # GNN: recorded through the counted FLOPs only


def _run_model_cell(arch: str, shape: str) -> tuple:
    """(cell, memory, Cost) of one step of a model cell on ``meta``."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.analysis import cost

    cell = build_cell(arch, shape, device="meta")
    train = cell.kind == "train"
    model = _meta_model(arch, shape, train)
    first = cell.init_state(model) if train else model
    rest = tuple(_meta(spec) for spec in cell.args[1:])
    params = _nbytes(model)
    state = _nbytes(first) if train else params
    batch = sum(_nbytes(r) for r in rest)
    mem = {"params_bytes": params, "state_bytes": state,
           "batch_bytes": batch, "argument_size_in_bytes": state + batch}
    _, c = cost(cell.step, first, *rest)
    return cell, mem, c


def _run_cc_cell(shape: str) -> tuple:
    """(cell, memory, Cost) of a ``cc-adaptive`` cell: built on
    ``meta``; the cost is the bound model's of one round."""
    from repro_torch.configs import cc_graphs
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.analysis import Cost

    cell = build_cell("cc-adaptive", shape, device="meta")
    rows = cell.args[0][0][0]
    v = cc_graphs.input_specs(shape)["num_nodes"]
    edges, labels = rows * 2 * 4, v * 4
    mem = {"state_bytes": edges + labels, "edges_bytes": edges,
           "labels_bytes": labels, "argument_size_in_bytes": edges}
    return cell, mem, Cost(bytes=8 * rows + 8 * v)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             out_path: str | None = None, verbose: bool = True) -> dict:
    from repro_torch.roofline import analysis as RA

    if multi_pod:
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh(multi_pod=True)
    t0 = time.perf_counter()
    if arch == "cc-adaptive":
        cell, mem, c = _run_cc_cell(shape)
    else:
        cell, mem, c = _run_model_cell(arch, shape)
    t_run = time.perf_counter() - t0
    mem["total_gib"] = round(mem["argument_size_in_bytes"] / 2**30, 3)

    model_flops = _model_flops(arch, shape)
    roof = RA.analyze(c, arch=arch, shape=shape, model_flops=model_flops)
    rec = {
        "arch": arch, "shape": shape, "mesh": MESH, "chips": 1,
        "kind": cell.kind, "run_s": round(t_run, 2), "memory": mem,
        "roofline": roof.as_dict(), "model_flops": model_flops,
        "ops": c.ops, "kernels": c.kernels, "ranges": c.ranges,
    }
    if arch == "cc-adaptive":
        rec["roofline_per"] = "round"
    if verbose:
        report(rec)
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def report(rec: dict) -> None:
    """Print one cell's record as ``run_cell`` does."""
    mem, roof = rec["memory"], rec["roofline"]
    print(f"[dryrun] {rec['arch']} x {rec['shape']} on {MESH}: OK (meta "
          f"run {rec['run_s']:.1f}s, {rec['ops']} ops)")
    print(f"  memory: {mem['total_gib']} GiB of arguments "
          f"(state {mem['state_bytes'] / 2**30:.2f} GiB)")
    per = " a round" if rec.get("roofline_per") else ""
    print(f"  roofline{per}: compute {roof['t_compute'] * 1e3:.2f} ms | "
          f"memory {roof['t_memory'] * 1e3:.2f} ms | collective "
          f"{roof['t_collective'] * 1e3:.2f} ms -> "
          f"{roof['bottleneck']}-bound")


def _run_quietly(cell: tuple) -> tuple:
    """(record, None) or (None, (repr, traceback)): one cell in a worker
    process."""
    try:
        return run_cell(*cell, verbose=False), None
    except Exception as e:   # noqa: BLE001 — reported by the parent
        return None, (repr(e), traceback.format_exc())


def cells_of(arch: str, shape: str | None = None) -> list:
    """The ``(arch, shape, skip reason)`` cells ``--arch`` names."""
    from repro_torch.configs import all_cells, cc_graphs, get_arch

    if arch == "all":
        return all_cells() + [("cc-adaptive", s, None)
                              for s in cc_graphs.SHAPES]
    if arch == "cc-adaptive":
        shapes = [shape] if shape else list(cc_graphs.SHAPES)
        return [("cc-adaptive", s, None) for s in shapes]
    mod = get_arch(arch)
    shapes = [shape] if shape else list(mod.SHAPES)
    return [(arch, s, mod.skip_reason(s)) for s in shapes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True,
                    help="arch id | 'all' | 'cc-adaptive'")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (spawned) over the cells")
    args = ap.parse_args(argv)

    done = set()
    if args.skip_existing and args.out:
        try:
            with open(args.out) as f:
                for line in f:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
        except FileNotFoundError:
            pass

    todo = []
    for arch, shape, skip in cells_of(args.arch, args.shape):
        if skip:
            print(f"[dryrun] SKIP {arch} x {shape}: {skip}")
        elif (arch, shape, MESH) in done:
            print(f"[dryrun] cached {arch} x {shape}")
        else:
            todo.append((arch, shape, args.multi_pod))
    failures = []
    if args.jobs > 1 and len(todo) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # the deepest cells first, so no worker starts one last
        order = sorted(todo, key=lambda c: c[1] != "train_4k")
        with ProcessPoolExecutor(
                min(args.jobs, len(todo)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            results = dict(zip(order, pool.map(_run_quietly, order)))
        for cell in todo:
            rec, err = results[cell]
            if err is not None:
                print(err[1], end="", file=sys.stderr)
                failures.append((cell[0], cell[1], err[0]))
                continue
            report(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    else:
        for arch, shape, multi_pod in todo:
            try:
                run_cell(arch, shape, multi_pod, out_path=args.out)
            except Exception as e:   # noqa: BLE001
                traceback.print_exc()
                failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:", failures)
        return 1
    print("[dryrun] all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
