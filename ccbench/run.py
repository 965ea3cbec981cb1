"""Run one cell of the benchmark on the card:

    python3 ccbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints earlier lines (the card, the plan,
the routes, kernel launches), then as its last line on standard output
one JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and, traced, ``breakdown``) and ``checks`` last; the numbers
compared with their limits are also the last lines on standard error.
Exits with 2, printing no result, when there is no card, or fewer cards
than the cell asks for; with 1 when a JAX module or the reference
package is loaded once the window has closed.

``--control truncated`` puts the plain reference, cut one hooking round
short, in the program's place: the run must come out not correct.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Pin what decides a route and keep every cache inside the
    checkout, at fixed paths."""
    # a measured autotune cache would route ``method="auto"`` by whatever
    # machine wrote it: every run plans from the heuristic
    os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
    cache = ROOT / "build" / "ccbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("truncated",), default=None)
    args = ap.parse_args(argv)
    _environment()
    t0 = time.perf_counter()
    import torch
    torch.set_num_threads(4)
    from ccbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"ccbench: needs {chips[args.workload]} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    # set-up is timed from here: loading PyTorch and making the CUDA
    # context are the machine's, not the program's (8-9 s and 0.3-1.6 s on
    # the chip machine, drifting between calls); the program's import, the
    # data, its session and the warm-up follow
    torch.empty(1, device="cuda:0")
    t_setup = time.perf_counter()
    print(f"ccbench: torch import and CUDA context {t_setup - t0:.3f} s",
          flush=True)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", t_setup,
                              control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"ccbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
