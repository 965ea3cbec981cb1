"""A traced run of one cell with the port's own tracer on, so that each
idle gap of the device names the engine phase and the host read behind
it:

    python3 ccbench/program_trace.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on the card. The cell is set up as
``run.py --trace 1`` sets it up. Then ``repro_torch.obs`` tracing goes
on, with its ``torch.profiler`` bridge (after the set-up, so that no
device ``Metrics`` attach to a churn session); the cell's traced
iterations are profiled; the tracer is reset at the window's start; the
window is measured; the tracer is read and turned off; and the answers
are checked as in any run. The last line on standard output is one JSON
object:

* ``metrics``: the cell's traced per-layer metrics, read by the
  benchmark's own readers, so they carry the tracer's cost;
* ``program``: the window's ``{"spans": {name: [seconds, ...]},
  "tags": {name: [tags, ...]}, "counters": {...}, "dropped": n}``;
* ``derived``: from ``program``, reads per solve or per tick (every
  ``read.*`` counter but ``read.work``, the drain that the churn driver's
  read of ``Solver.work`` makes after each traced tick), the median
  ``cc.scan`` and ``cc.cleanup`` (solve cells) or ``dyn.forest.skeleton``
  (churn cells) in ms, the seconds of each span and the host's seconds
  blocked at each read site; a value is ``None`` when the ring buffer
  dropped a span or the span is absent;
* ``breakdown``: the traced block's device operations and idle gaps.
  A gap's label is ``<benchmark span>:<innermost program span>:<host
  op>``, or ``<benchmark span>:<host op>`` where no program span covers
  it; the device rows of every user annotation are left out of busy
  time, the program's ranges with the benchmark's.

``BENCHMARK.json`` does not run this: the benchmark's own runs keep the
tracer off.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from ccbench import harness, profile  # noqa: E402

CAPACITY = 1 << 16


def reduce(prof, program: set, top: int = 10) -> dict:
    """``profile.reduce`` with the program's spans (the names in
    ``program``) as a second tier of ranges: their device rows are no
    operation, and a gap under one names the innermost."""
    from torch.autograd import DeviceType
    window, bench, ranges, cpu, dev = None, [], [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        ranged = ev.name.startswith(profile.SPAN_PREFIX) \
            or ev.name in program
        if ev.device_type == DeviceType.CPU:
            if ev.name == profile.WINDOW:
                window = (s, e)
            elif ev.name.startswith(profile.SPAN_PREFIX):
                bench.append((ev.name, s, e))
            elif ev.name in program:
                ranges.append((ev.name, s, e))
            else:
                cpu.append((ev.name, s, e))
        elif e > s and not ranged \
                and not getattr(ev, "is_user_annotation", False):
            dev.append((ev.name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {profile.WINDOW!r} range")
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
              if e > w0 and s < w1]
    merged = profile._merge([(s, e) for _, s, e in inside])
    ops: dict = {}
    for name, s, e in inside:
        ops[name] = ops.get(name, 0.0) + (e - s)
    cpu.sort(key=lambda r: r[1])
    starts = [r[1] for r in cpu]
    ranges.sort(key=lambda r: r[1])
    gaps: dict = {}
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            t = (edge + s) / 2
            outer, op = profile._host_label(bench, cpu, starts,
                                            t).split(":", 1)
            inner = [n for n, rs, re in ranges if rs <= t <= re]
            label = ":".join([outer] + inner[-1:] + [op])
            gaps[label] = gaps.get(label, 0.0) + (s - edge)
        edge = max(edge, e)
    def by_time(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(e - s for s, e in merged), "window_s": w1 - w0,
            "device_ops": by_time(ops), "idle_gaps": by_time(gaps)}


def traced_block(drv, spans, iterations: int) -> dict:
    """``harness.traced_block`` with the program's ranges reduced by
    ``reduce``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from repro_torch.obs import trace as obs
    acts = [ProfilerActivity.CPU]
    if drv.cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.record = False
    summary = None
    for _ in range(3):
        obs.tracer().reset()
        work = 0
        with torch_profile(activities=acts) as prof:
            harness.sync(drv.cell.device)
            with torch.profiler.record_function(profile.WINDOW):
                for _ in range(iterations):
                    work += drv.step(spans)[1]
                harness.sync(drv.cell.device)
        names = {e["name"] for e in obs.tracer().log.events()}
        summary = reduce(prof, names)
        summary.update(work=work, iterations=iterations)
        if summary["busy_s"] > 0 or drv.cell.device.type != "cuda":
            break
    spans.record = True
    return summary


def derive(program: dict, iterations: int, solve: bool) -> dict:
    """The five readings of the window's spans and counters (see the
    module docstring), with the seconds of each span and of each read
    site."""
    spans, counters = program["spans"], program["counters"]
    sound = program["dropped"] == 0

    def median_ms(name):
        times = spans.get(name)
        return statistics.median(times) * 1e3 if sound and times else None
    reads = sum(v for k, v in counters.items()
                if k.startswith("read.") and k != "read.work")
    per = reads / iterations if sound and iterations else None
    out = ({"host_reads_per_solve.solve": per,
            "scan_ms.solve": median_ms("cc.scan"),
            "cleanup_ms.solve": median_ms("cc.cleanup")} if solve else
           {"host_reads_per_tick.churn": per,
            "skeleton_ms.churn": median_ms("dyn.forest.skeleton")})
    out["span_s"] = {k: sum(v) for k, v in sorted(spans.items())}
    out["span_count"] = {k: len(v) for k, v in sorted(spans.items())}
    out["reads"] = {k: v for k, v in sorted(counters.items())
                    if k.startswith("read.")}
    out["read_s"] = {k.removeprefix("read_ns."): v / 1e9
                     for k, v in sorted(counters.items())
                     if k.startswith("read_ns.")}
    return out


def run(root: Path, workload: str, seed: int, seconds: float, device,
        out=None) -> dict:
    """One traced run with the program's tracer on; returns the result
    object."""
    from repro_torch.obs import trace as obs
    device = torch.device(device)
    bench = harness.load_json(root / "BENCHMARK.json")
    cell = harness.Cell(root, bench, workload, seed, device, None, out,
                        time.perf_counter(), True)
    drv = cell.driver_module.Driver(cell)
    drv.setup()
    harness.sync(device)
    spans = harness.Spans(device)
    obs.enable(capacity=CAPACITY, torch_annotations=True)
    try:
        prof = traced_block(drv, spans,
                            int(cell.traffic["traced_iterations"]))
        obs.tracer().reset()
        lat, work, window_s = harness.measure(drv, seconds, spans)
        tr = obs.tracer()
        by_name: dict = {}
        tags: dict = {}
        for ev in tr.log.events():
            by_name.setdefault(ev["name"], []).append(ev["dur_us"] / 1e6)
            if "tags" in ev:
                tags.setdefault(ev["name"], []).append(ev["tags"])
        program = {"spans": by_name, "tags": tags,
                   "counters": dict(tr.counters), "dropped": tr.log.dropped}
    finally:
        obs.disable()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    ctx = {"workload": workload, "trace": True, "setup_s": None,
           "latencies_s": lat, "work": work, "window_s": window_s,
           "iterations": len(lat),
           "spans": {k: list(v) for k, v in spans.times.items()},
           "counters": drv.counters(), "profile": prof,
           "num_nodes": drv.num_nodes, "num_edges": drv.num_edges,
           "device_kind": kind, "launches_per_iteration": {}}
    metrics = {}
    for m in harness.cell_metrics(bench, workload, True):
        reader = harness.load_module(
            cell.bench_dir / "metrics" / f"{m['name']}.py",
            "ccbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = value
    lines = drv.describe()
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    return {"workload": workload, "seed": seed,
            "correct": bool(checks) and all(v <= lim for v, lim
                                            in checks.values()),
            "device": harness.card_line(device), "iterations": len(lat),
            "window_s": window_s, "metrics": metrics,
            "derived": derive(program, len(lat),
                              workload.endswith(".solve")),
            "describe": lines, "program": program,
            "breakdown": {"busy_s": prof["busy_s"],
                          "window_s": prof["window_s"],
                          "device_ops": prof["device_ops"],
                          "idle_gaps": prof["idle_gaps"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None,
                    help="also write the whole result, every span's "
                         "seconds included, to this file")
    args = ap.parse_args(argv)
    from ccbench.run import _environment
    _environment()
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("ccbench: needs a CUDA device", file=sys.stderr)
        return 2
    torch.empty(1, device="cuda:0")
    result = run(ROOT, args.workload, args.seed, args.seconds, "cuda:0")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    # the last line without the per-span lists, which can run long
    result["program"] = {k: v for k, v in result["program"].items()
                         if k not in ("spans", "tags")}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
