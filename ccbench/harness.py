"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json`` (the entry's ``file``) names a generator
    (``generators/<generator>.py``: ``generate(params, gen, device)``)
    and its parameters;
  * ``traffic/<traffic>.json`` names a driver (``drivers/<driver>.py``:
    a ``Driver(cell)`` with ``setup``, ``step``, ``describe``,
    ``release`` and ``check``) and its parameters;
  * ``metrics/<metric>.py`` is the reader of one metric:
    ``read(ctx) -> float | None``; ``None`` leaves the metric out.

A run sets up (generation, the program's session, warm-up through the
window's own calls); a traced run then profiles a few iterations; the
run measures for ``seconds`` on the host clock. It then frees the
program's state and holds the answers it kept against the plain
reference (``reference.py``).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names that no process of the benchmark may hold: the
# JAX stack and the reference package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import a harness file by path (metric files have dots in their
    names, so they cannot be imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_for(seed: int, *keys) -> int:
    """A 63-bit generator seed for one use (``keys``) of the run's
    ``--seed``: independent streams for the graph, each instance and the
    update stream, the same for the same seed."""
    words = [int(seed) % 2**64] + [
        k if isinstance(k, int) else int.from_bytes(str(k).encode(), "little")
        for k in keys]
    s = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(s[0]) << 31) ^ int(s[1])


def generator(device: torch.device, seed: int, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, *keys))
    return g


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN_MODULES``, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


class Spans:
    """The benchmark's own host spans around calls into a layer, each
    ending in a synchronise, and a profiler range of the same name."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times: dict = defaultdict(list)
        self.record = True

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function("ccbench." + name):
            t0 = time.perf_counter()
            yield
            sync(self.device)
            dt = time.perf_counter() - t0
        if self.record:
            self.times[name].append(dt)


class Reservoir:
    """A uniform sample of ``k`` of the items offered (Algorithm R),
    drawn from the run's seed; ``make`` is called only for items kept."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


class Cell:
    """What a driver gets: the cell's entries and files, the seed, the
    device, the generator, and where to print its earlier lines."""

    def __init__(self, root: Path, bench: dict, workload: str, seed: int,
                 device: torch.device, control: str | None = None,
                 out=None, t_start: float = 0.0, traced: bool = False):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.root, self.bench = root, bench
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        bench_dir = root / BENCH_DIR.name
        self.traffic = load_json(
            bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.gen = load_module(
            bench_dir / "generators" / f"{self.config['generator']}.py",
            f"ccbench_generator_{self.config['generator']}")
        self.driver_module = load_module(
            bench_dir / "drivers" / f"{self.traffic['driver']}.py",
            f"ccbench_driver_{self.traffic['driver']}")
        self.bench_dir = bench_dir
        self.seed, self.device, self.control = int(seed), device, control
        self.out = out if out is not None else sys.stdout
        self.t_start = t_start
        self.traced = traced

    def say(self, line: str) -> None:
        print(f"ccbench: {line}", file=self.out, flush=True)

    def mark(self, marks: dict, name: str) -> None:
        """Record when a step of the set-up ended (seconds from the
        start of the process)."""
        marks[name] = time.perf_counter() - self.t_start

    def graph(self, *keys) -> tuple[torch.Tensor, int]:
        """The configuration's graph for one use of the seed."""
        return self.gen.generate(self.config["params"],
                                 generator(self.device, self.seed, *keys),
                                 self.device)


def launch_counts() -> dict:
    """The CC kernel wrappers' launch counters (K1 cc_fused, K2 hook, K3
    multi_jump); importing them builds nothing."""
    from repro_torch.kernels.cc_fused import ops as cc_ops
    from repro_torch.kernels.hook import ops as hook_ops
    from repro_torch.kernels.multi_jump import ops as mj_ops
    return {"K1_cc_fused": cc_ops.KERNEL.launches + cc_ops.BATCHED.launches,
            "K2_hook": hook_ops.KERNEL.launches,
            "K3_multi_jump": mj_ops.KERNEL.launches}


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return f"device {device} (no card)"
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        limit = f"nvidia-smi failed: {exc}"
    return f"device {name}; nvidia-smi: {limit}"


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without ``--trace``, else the per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def measure(drv, seconds: float, spans) -> tuple[list, float, float]:
    """The window: back-to-back iterations until ``seconds`` have passed;
    the last iteration runs to its end. Returns (latencies in seconds,
    the work units done, the window's seconds)."""
    lat, work = [], 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        dt, units = drv.step(spans)
        lat.append(dt)
        work += units
    return lat, work, time.perf_counter() - t0


def traced_block(drv, spans: Spans, iterations: int) -> dict | None:
    """Profile ``iterations`` iterations (their spans are not recorded)
    and reduce the trace, with the work units those iterations did; a
    trace that lost every device event is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from ccbench.profile import WINDOW, reduce
    acts = [ProfilerActivity.CPU]
    if drv.cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.record = False
    summary = None
    for _ in range(3):
        work = 0
        with torch_profile(activities=acts) as prof:
            sync(drv.cell.device)
            with torch.profiler.record_function(WINDOW):
                for _ in range(iterations):
                    work += drv.step(spans)[1]
                sync(drv.cell.device)
        summary = reduce(prof)
        summary.update(work=work, iterations=iterations)
        if summary["busy_s"] > 0 or drv.cell.device.type != "cuda":
            break
    spans.record = True
    return summary


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: str | None = None,
             out=None, err=None) -> dict:
    """One run; returns the result object (its ``checks`` key last)."""
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    bench = load_json(root / "BENCHMARK.json")
    cell = Cell(root, bench, workload, seed, device, control, out, t_start,
                trace)
    cell.say(f"cell {workload}: config {cell.config_entry['name']}, "
             f"traffic {cell.workload['traffic']}, seed {seed}, "
             f"seconds {seconds}, trace {int(trace)}"
             + (f", control {control}" if control else ""))
    drv = cell.driver_module.Driver(cell)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    cell.say(f"setup_s {setup_s}; seconds from its start "
             + " ".join(f"{k} {v:.3f}" for k, v in drv.marks.items()))
    spans = Spans(device) if trace else None
    prof = None
    if trace:
        # before the window: a window can end in a tick far longer than
        # the rest, whose trace would take minutes to read
        prof = traced_block(drv, spans, int(cell.traffic["traced_iterations"]))
    before = launch_counts()
    lat, work, window_s = measure(drv, seconds, spans)
    after = launch_counts()
    per = {k: (after[k] - before[k]) / max(len(lat), 1) for k in after}
    cell.say(f"window {window_s} s, {len(lat)} iterations; kernel launches "
             f"per iteration {json.dumps(per)}")
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, [0, 10, 50, 90, 100])
        cell.say("latency ms min/p10/p50/p90/max "
                 + " ".join(f"{v:.3f}" for v in q))
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    cell.say(card_line(device))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    for line in drv.describe():
        cell.say(line)
    ctx = {"workload": workload, "trace": trace, "setup_s": setup_s,
           "latencies_s": lat, "work": work, "window_s": window_s,
           "iterations": len(lat),
           "spans": {k: list(v) for k, v in (spans.times if spans else
                                             {}).items()},
           "counters": drv.counters(), "profile": prof,
           "num_nodes": drv.num_nodes, "num_edges": drv.num_edges,
           "device_kind": kind,
           "launches_per_iteration": per}
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        reader = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py",
                             "ccbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = len(lat) + (int(cell.traffic["traced_iterations"])
                            if trace else 0)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=err, flush=True)
    return result
