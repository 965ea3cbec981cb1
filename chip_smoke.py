#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. card and build: the card's name and power limit from ``nvidia-smi``;
   ``nvcc`` builds the three kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them, bit-equal (integer work, tolerance
   0), each timed with CUDA events (median of 3 after a warm-up);
3. the main path at full scale: ``solve_static(method="pallas_fused")``
   and ``solve_pallas`` on the Table I stand-ins usa-osm and kron-logn21
   at scale 1.0 (seed 1), with the launch counts of every kernel set to
   0 just before and read just after; labels equal the scipy oracle,
   ``pallas_fused`` WorkCounters equal the torch-ops ``adaptive`` solve,
   and the fused kernel launches once per scan plus once per cleanup
   round;
4. parity constants: the four stand-ins at scale 0.002 reproduce the
   reference's WorkCounters and summed scan sweeps on the card;
5. end-to-end solve times (median of 3 after a warm-up).

It prints informative lines, then one JSON line of per-kernel numbers,
then, as its last line, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or away from the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"
SCALE = 1.0                        # of the full-scale stand-ins
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
SECTOR = 32                        # bytes a random 4-byte read costs in DRAM
FULL_SCALE = ("usa-osm", "kron-logn21")
# table1_scaled(name, scale=0.002, seed=1): (|V|, |E|, s), the reference's
# adaptive WorkCounters, and the summed per-segment sweeps of its scan
PARITY = {
    "usa-osm": ((47961, 62909, 3), (566181, 1390869, 29, 5, 1), 20),
    "euro-osm-karls": ((346921, 456990, 3),
                       (4112910, 11448393, 33, 5, 1), 22),
    "soc-live-journal": ((8192, 57344, 14), (344064, 270336, 33, 15, 1), 32),
    "kron-logn21": ((2048, 88064, 86), (528384, 204800, 100, 87, 1), 99),
}
COUNTERS = ("hook_ops", "jump_ops", "jump_sweeps", "hook_rounds",
            "sync_rounds")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import cc, rounds
    from repro_torch.core.unionfind import connected_components_scipy
    from repro_torch.graphs.device import DeviceGraph
    from repro_torch.graphs.generators import table1_scaled
    from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
    from repro_torch.kernels.hook import ops as hook_ops, ref as hook_ref
    from repro_torch.kernels.multi_jump import ops as mj_ops, ref as mj_ref

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)

    # -- 1. build ----------------------------------------------------------
    report = kernels.build()
    print(f"build: {report['seconds']:.2f} s (nvcc, sm_90a, "
          f"{len(report['ptxas'])} sources built in parallel)")
    for name, text in report["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    graphs = {name: DeviceGraph.from_host(
        table1_scaled(name, scale=SCALE, seed=1), device=dev)
        for name in FULL_SCALE}
    for name, g in graphs.items():
        print(f"graph {name}: |V|={g.num_nodes} |E|={g.true_edges} "
              f"s={g.plan.num_segments} seg={g.plan.segment_size}")
    print(f"generate: {time.perf_counter() - t0:.1f} s")

    # -- 2. kernels vs plain, at the path's shapes -------------------------
    rows = {}
    scans = {}
    for name, g in graphs.items():
        segs = rounds.pad_and_segment(g.edges, g.plan)
        counts = rounds.segment_true_counts(g.true_edges, g.plan, device=dev)
        pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
        got_pi, got_sw = cc_ops.fused_segment_scan(pi0, segs, counts)
        want_pi, want_sw = cc_ref.ref_segment_scan(pi0, segs, counts)
        torch.cuda.synchronize()
        err = max(max_abs_err(got_pi, want_pi),
                  max_abs_err(got_sw, want_sw))
        check(err == 0, f"cc_fused differs from its plain version on {name}")
        sweeps = int(got_sw.sum())
        print(f"cc_fused {name}: pi and sweeps equal to plain "
              f"(summed sweeps {sweeps})")
        n_edges = segs.shape[0] * segs.shape[1]
        stream = 8 * n_edges + 8 * g.num_nodes * (sweeps + 1)
        sector = (8 + (2 + 2 * 2 + 1) * SECTOR) * n_edges \
            + (4 + SECTOR + 4) * g.num_nodes * sweeps
        scans[name] = (segs, counts, dict(
            shape=f"{name} scan: V={g.num_nodes}, "
                  f"S={segs.shape[0]}x{segs.shape[1]}, {sweeps} sweeps",
            max_abs_err=err,
            ms=time_ms(torch, lambda: cc_ops.fused_segment_scan(
                pi0, segs, counts)),
            plain_ms=time_ms(torch, lambda: cc_ref.ref_segment_scan(
                pi0, segs, counts)),
            bound_ms=bound_ms(stream), bound_sector_ms=bound_ms(sector)))
        print(f"cc_fused {name}: {scans[name][2]}")
    rows["cc_fused"] = dict(
        name="cc_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/cc_fused.cu",
        replaces="src/repro/kernels/cc_fused/cc_fused.py:122",
        equal=True, **scans["kron-logn21"][2], bound_by="bytes",
        library_ms=None, also=[scans["usa-osm"][2]])

    g = graphs["usa-osm"]
    segs = scans["usa-osm"][0]
    seg0 = segs[0]
    pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
    got = hook_ops.hook_edges_pallas(pi0, seg0, edge_tile=1024, lift_steps=2)
    want = hook_ref.ref_hook_tiled(pi0, seg0, 1024, 2)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "hook differs from its plain tiled version on usa-osm")
    print(f"hook usa-osm segment 0 ({seg0.shape[0]} edges, tile 1024): "
          "equal to plain")
    n_edges = seg0.shape[0]
    rows["hook"] = dict(
        name="hook", route="cuda",
        source="src/repro_torch/kernels/csrc/hook.cu",
        replaces="src/repro/kernels/hook/hook.py:53",
        shape=f"usa-osm segment 0: E={n_edges}, V={g.num_nodes}, tile 1024",
        equal=True, max_abs_err=err,
        ms=time_ms(torch, lambda: hook_ops.hook_edges_pallas(
            pi0, seg0, edge_tile=1024, lift_steps=2)),
        plain_ms=time_ms(torch, lambda: hook_ref.ref_hook_tiled(
            pi0, seg0, 1024, 2)),
        bound_ms=bound_ms(8 * n_edges + 8 * g.num_nodes), bound_by="bytes",
        bound_sector_ms=bound_ms((8 + 7 * SECTOR) * n_edges
                                 + 8 * g.num_nodes),
        library_ms=None)

    g = graphs["kron-logn21"]
    segs = scans["kron-logn21"][0]
    pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
    hooked = rounds.hook_edges(pi0, segs[0], lift_steps=2)  # compress input
    got = mj_ops.multi_jump(hooked, tile=512, rounds=2)
    want = mj_ref.ref_multi_jump_sweep(hooked, 512, 2)
    full = mj_ops.full_compress(hooked, tile=512)
    torch.cuda.synchronize()
    err = max(max_abs_err(got, want),
              max_abs_err(full, mj_ref.ref_full_compress(hooked)))
    check(err == 0, "multi_jump differs from its plain version on kron")
    print(f"multi_jump kron-logn21 (V={g.num_nodes}, tile 512): one sweep "
          "and full_compress equal to plain")
    rows["multi_jump"] = dict(
        name="multi_jump", route="cuda",
        source="src/repro_torch/kernels/csrc/multi_jump.cu",
        replaces="src/repro/kernels/multi_jump/multi_jump.py:56",
        shape=f"kron-logn21 one sweep: V={g.num_nodes}, tile 512, rounds 2",
        equal=True, max_abs_err=err,
        ms=time_ms(torch, lambda: mj_ops.multi_jump(hooked, tile=512)),
        plain_ms=time_ms(torch, lambda: mj_ref.ref_multi_jump_sweep(
            hooked, 512, 2)),
        bound_ms=bound_ms(8 * g.num_nodes), bound_by="bytes",
        bound_sector_ms=bound_ms((8 + 2 * SECTOR) * g.num_nodes),
        library_ms=None)
    del hooked, got, want, full

    # -- 3. the main path at full scale, launches counted ------------------
    ks = {"cc_fused": cc_ops.KERNEL, "hook": hook_ops.KERNEL,
          "multi_jump": mj_ops.KERNEL}
    for k in ks.values():
        k.launches = 0
    t0 = time.perf_counter()
    results = {}
    for name, g in graphs.items():
        before = cc_ops.KERNEL.launches
        fused = cc.solve_static(g, method="pallas_fused")
        fused_launches = cc_ops.KERNEL.launches - before
        labels = cc.solve_pallas(g)
        results[name] = (fused, fused_launches, labels)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in ks.items()}
    print(f"main path (pallas_fused + pallas on {', '.join(FULL_SCALE)}): "
          f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched on the main path")
    for name, g in graphs.items():
        fused, fused_launches, labels = results[name]
        want = connected_components_scipy(g.edges.cpu().numpy(),
                                          g.num_nodes)
        check(np.array_equal(fused.labels.cpu().numpy(), want),
              f"pallas_fused labels differ from the oracle on {name}")
        check(np.array_equal(labels.cpu().numpy(), want),
              f"pallas labels differ from the oracle on {name}")
        adaptive = cc.solve_static(g, method="adaptive")
        check(np.array_equal(adaptive.labels.cpu().numpy(), want),
              f"adaptive labels differ from the oracle on {name}")
        fw, aw = fused.work.as_ints(), adaptive.work.as_ints()
        check(fw == aw, f"pallas_fused counters {fw} != adaptive {aw} "
                        f"on {name}")
        cleanup = aw["hook_rounds"] - g.plan.num_segments
        check(fused_launches == 1 + cleanup,
              f"cc_fused launched {fused_launches} times on {name}, "
              f"expected 1 + {cleanup} cleanup rounds")
        print(f"{name}: labels == scipy oracle ({len(np.unique(want))} "
              f"components); pallas_fused counters == adaptive {aw}; "
              f"cc_fused launches {fused_launches} = 1 + {cleanup} cleanup")
    for k, row in rows.items():
        row["launches"] = launches[k]
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 4. parity constants at scale 0.002 --------------------------------
    for name, (shape, counters, scan_sweeps) in PARITY.items():
        g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1),
                                  device=dev)
        check((g.num_nodes, g.true_edges, g.plan.num_segments) == shape,
              f"{name} stand-in shape")
        want = dict(zip(COUNTERS, counters))
        for method in ("adaptive", "pallas_fused"):
            got = cc.solve_static(g, method=method).work.as_ints()
            check(got == want, f"{name} {method} counters {got} != {want}")
        segs = rounds.pad_and_segment(g.edges, g.plan)
        counts = rounds.segment_true_counts(g.true_edges, g.plan, device=dev)
        _, sw = cc_ops.fused_segment_scan(
            torch.arange(g.num_nodes, dtype=torch.int32, device=dev),
            segs, counts)
        check(int(sw.sum()) == scan_sweeps, f"{name} scan sweeps")
        print(f"parity {name} @0.002: counters {counters} and scan sweeps "
              f"{scan_sweeps} reproduced")

    # -- 5. end-to-end times -----------------------------------------------
    e2e = {}
    for name, g in graphs.items():
        e2e[name] = {
            "pallas_fused_ms": time_ms(
                torch, lambda: cc.solve_static(g, method="pallas_fused")),
            "pallas_ms": time_ms(torch, lambda: cc.solve_pallas(g)),
            "adaptive_ms": time_ms(
                torch, lambda: cc.solve_static(g, method="adaptive")),
        }
        print(f"e2e {name}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in e2e[name].items()))
    print("e2e " + json.dumps(e2e))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rows[k] for k in
                                  ("cc_fused", "hook", "multi_jump")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
