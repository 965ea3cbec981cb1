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
5. end-to-end solve times (median of 3 after a warm-up);

then the recsys serving slice, DCN-v2 at full width (26 Criteo tables,
19,297,856 x 16 bf16 rows, random weights from a seeded generator):

6. ``embedding_bag`` against its plain version on the full table at the
   path's shapes (serve_p99 13,312 bags of 1, serve_bulk 6,815,744,
   retrieval_cand 1,000,000, and a multi-hot B=512 x 26 x H=4, sum and
   mean): bags of 1 bit-equal, larger bags within one bfloat16 ulp;
   timed beside ``F.embedding_bag``;
7. the ragged EmbeddingBag path (``recsys.embedding_bag``, bags of 1-8
   rows, launches counted) and ``segment_reduce`` against its plain
   version on the gathered rows: sum within 1e-5 (1 + |ref|) in fp32
   and one bfloat16 ulp after the cast, min / max bit-equal; timed
   beside ``index_add_`` / ``scatter_reduce``;
8. the serving path through ``build_cell``: 8 ``serve_p99`` requests
   from a prefetched stream, one ``serve_bulk`` batch and one
   ``retrieval_cand`` query against 1,000,000 candidates, launch counts
   set to 0 just before and read just after; logits and scores finite
   and bit-equal to the same tower fed the plain lookup, the
   embedding-bag kernel launched once per request and twice per query;
9. serving times (CUDA events, median after a warm-up, host batch to
   logits);
10. where each serving cell's time goes: the host-to-device copy, the
    lookup (``interact``) and the tower timed apart, and the device's
    idle share of a step from ``torch.profiler``: one minus the device
    time of its kernels and copies (and of its kernels alone) over the
    step time of phase 9.

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
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
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


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``nops`` fp32 operations outside the tensor cores, and which of the
    two bounds it."""
    by_bytes = bound_ms(nbytes)
    by_ops = nops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bf16_ulp(torch, x):
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    e = torch.floor(torch.log2(torch.clamp(x.float().abs(), min=2.0**-126)))
    return torch.exp2(e - 7)


def float_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def recsys_phases(torch, np, dev, rows: dict) -> dict:
    """Phases 6-10: DCN-v2 at full width. Adds the ``embedding_bag`` and
    ``segment_reduce`` rows to ``rows``; returns the serving times."""
    import torch.nn.functional as F

    from repro_torch.configs import dcn_v2
    from repro_torch.data.pipeline import (make_stream, recsys_batch,
                                           recsys_batches)
    from repro_torch.kernels.embedding_bag import ops as eb_ops, \
        ref as eb_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, \
        ref as sr_ref
    from repro_torch.launch import steps
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    cfg = dcn_v2.make_config()
    shapes = dcn_v2.SHAPE_DEFS
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    table, offsets = model.table, model.row_offsets
    print(f"dcn-v2: {recsys.param_count(cfg)} parameters, table "
          f"{tuple(table.shape)} {table.dtype}, d_interact "
          f"{cfg.d_interact}; init {time.perf_counter() - t0:.1f} s")

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def flat_idx(batch):
        return (batch["sparse_idx"] + offsets).reshape(
            batch["sparse_idx"].shape[0] * cfg.n_sparse, -1).contiguous()

    host = {s: recsys_batch(1, 0, shapes[s]["batch"], cfg.n_dense,
                            cfg.table_sizes)
            for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    cand_host = np.random.default_rng(1).integers(
        0, cfg.table_sizes[0], shapes["retrieval_cand"]["candidates"]
    ).astype(np.int32)
    rng = np.random.default_rng(1)
    multi = torch.from_numpy(np.stack(
        [rng.integers(0, s, (512, 4)) for s in cfg.table_sizes],
        1).astype(np.int32)).to(dev)
    multi = (multi + offsets[None, :, None]).reshape(-1, 4).contiguous()

    # -- 6. embedding_bag vs plain on the full table -----------------------
    esize = table.element_size()
    cases = {
        "serve_p99": (flat_idx(on_dev(host["serve_p99"])), "sum"),
        "serve_bulk": (flat_idx(on_dev(host["serve_bulk"])), "sum"),
        "retrieval_cand": (torch.from_numpy(cand_host).to(dev)[:, None]
                           .contiguous(), "sum"),
        "multi_hot_sum": (multi, "sum"),
        "multi_hot_mean": (multi, "mean"),
    }
    eb = {}
    for name, (idx, combine) in cases.items():
        got = eb_ops.embedding_bag(table, idx, combine=combine)
        want = eb_ref.ref_embedding_bag(table, idx, combine)
        torch.cuda.synchronize()
        b, bag = idx.shape
        equal = torch.equal(got, want)
        if bag == 1:
            check(equal, f"embedding_bag {name} differs from the gather")
        ulps = float(((got.float() - want.float()).abs()
                      / bf16_ulp(torch, want)).max())
        check(ulps <= 1.0, f"embedding_bag {name}: {ulps} ulp from plain")
        idx64 = idx.long()
        ms_bound, by = bound(b * bag * (4 + cfg.embed_dim * esize)
                             + b * cfg.embed_dim * esize,
                             b * bag * cfg.embed_dim)
        eb[name] = dict(
            shape=f"{name}: {b} bags x {bag}, table "
                  f"{table.shape[0]}x{table.shape[1]} {combine}",
            equal=equal, max_abs_err=float_err(got, want),
            max_ulp=ulps,
            ms=time_ms(torch, lambda: eb_ops.embedding_bag(
                table, idx, combine=combine)),
            plain_ms=time_ms(torch, lambda: eb_ref.ref_embedding_bag(
                table, idx, combine)),
            library_ms=time_ms(torch, lambda: F.embedding_bag(
                idx64, table, mode=combine)),
            bound_ms=ms_bound, bound_by=by)
        print(f"embedding_bag {name}: {eb[name]}")
        del got, want, idx64

    # -- 7. the ragged EmbeddingBag path and segment_reduce ----------------
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 9, 512 * cfg.n_sparse)
    feat = np.tile(np.arange(cfg.n_sparse), 512)
    sizes = np.asarray(cfg.table_sizes)
    rows_per = [rng.integers(0, sizes[f], n) + cfg.row_offsets[f]
                for f, n in zip(feat, lengths)]
    nnz_idx = torch.from_numpy(np.concatenate(rows_per).astype(
        np.int32)).to(dev)
    bag_ids = torch.from_numpy(np.repeat(
        np.arange(lengths.size), lengths).astype(np.int32)).to(dev)
    num_bags = int(lengths.size)
    sr_ops.KERNEL.launches = 0
    ragged = {c: recsys.embedding_bag(table, nnz_idx, bag_ids, num_bags, c)
              for c in ("sum", "mean")}
    torch.cuda.synchronize()
    sr_launches = sr_ops.KERNEL.launches
    check(sr_launches == 3, f"segment_reduce launched {sr_launches} times "
                            "on the ragged path, expected 1 (sum) + 2 (mean)")
    gathered = table[nnz_idx.long()]
    for c, got in ragged.items():
        want = sr_ref.ref_segment_reduce(gathered, bag_ids, num_bags, "sum")
        if c == "mean":
            cnt = torch.from_numpy(lengths).to(dev).to(want.dtype)
            want = want / cnt[:, None]
        ulps = float(((got.float() - want.float()).abs()
                      / bf16_ulp(torch, want)).max())
        # sum: one rounding of two fp32 orders, 1 ulp; mean: that ulp
        # divided by a count that is not a power of two, plus the
        # division's own rounding, 2 ulp
        check(ulps <= (1.0 if c == "sum" else 2.0),
              f"recsys.embedding_bag {c}: {ulps} ulp")
        print(f"ragged embedding_bag {c}: {ulps} ulp from plain")
    print(f"ragged embedding_bag: {num_bags} bags, nnz "
          f"{nnz_idx.shape[0]}, lengths 1-8; segment_reduce launches "
          f"{sr_launches}")

    n, d = gathered.shape
    ids64 = bag_ids.long()
    ids2 = ids64[:, None].expand(n, d)
    sr = {}
    for op in ("sum", "min", "max"):
        # fp32 rows: the scratch's own numbers; bf16 rows: after the cast
        got32 = sr_ops.segment_reduce(gathered.float(), bag_ids, num_bags,
                                      op=op)
        want32 = sr_ref.ref_segment_reduce(gathered.float(), bag_ids,
                                           num_bags, op)
        got = sr_ops.segment_reduce(gathered, bag_ids, num_bags, op=op)
        want = sr_ref.ref_segment_reduce(gathered, bag_ids, num_bags, op)
        torch.cuda.synchronize()
        if op == "sum":
            check(bool(((got32 - want32).abs()
                        <= 1e-5 * (1 + want32.abs())).all()),
                  "segment_reduce sum (fp32) out of tolerance")
            check(bool(((got.float() - want.float()).abs()
                        <= bf16_ulp(torch, want)).all()),
                  "segment_reduce sum (bf16) over 1 ulp")
        else:
            check(torch.equal(got32, want32) and torch.equal(got, want),
                  f"segment_reduce {op} not bit-equal to plain")
        if op == "sum":
            library = lambda: torch.zeros(
                (num_bags, d), dtype=gathered.dtype, device=dev).index_add_(
                0, ids64, gathered)
        else:
            library = lambda op=op: torch.full(
                (num_bags, d), sr_ref.reduce_identity(op),
                dtype=gathered.dtype, device=dev).scatter_reduce_(
                0, ids2, gathered, "amin" if op == "min" else "amax")
        ms_bound, by = bound(n * d * esize + 4 * n + num_bags * d * esize,
                             n * d)
        sr[op] = dict(
            shape=f"{op}: N={n} rows x {d} bf16 into S={num_bags} (ragged "
                  "bags of 1-8)",
            equal=torch.equal(got, want), max_abs_err=float_err(got, want),
            max_abs_err_fp32=float_err(got32, want32),
            ms=time_ms(torch, lambda op=op: sr_ops.segment_reduce(
                gathered, bag_ids, num_bags, op=op)),
            plain_ms=time_ms(torch, lambda op=op: sr_ref.ref_segment_reduce(
                gathered, bag_ids, num_bags, op)),
            library_ms=time_ms(torch, library),
            bound_ms=ms_bound, bound_by=by)
        print(f"segment_reduce {op}: {sr[op]}")
    del gathered, ids2, ragged, got32, want32

    # -- 8. the serving path at full width, launches counted ---------------
    cells = {s: steps.build_cell("dcn-v2", s, device=dev)
             for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    stream = make_stream(recsys_batches, 1, shapes["serve_p99"]["batch"],
                         cfg.n_dense, cfg.table_sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eb_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    served, per_request = [], []
    for _ in range(8):
        batch = next(stream)
        before = eb_ops.KERNEL.launches
        served.append((batch, cells["serve_p99"].step(model, batch)))
        per_request.append(eb_ops.KERNEL.launches - before)
    bulk = cells["serve_bulk"].step(model, host["serve_bulk"])
    before = eb_ops.KERNEL.launches
    scores = cells["retrieval_cand"].step(model, host["retrieval_cand"],
                                          cand_host)
    retrieval_launches = eb_ops.KERNEL.launches - before
    torch.cuda.synchronize()
    eb_launches = eb_ops.KERNEL.launches
    print(f"serving path (8 x serve_p99, serve_bulk, retrieval_cand): "
          f"{time.perf_counter() - t0:.2f} s, embedding_bag launches "
          f"{eb_launches} (per request {per_request}, retrieval "
          f"{retrieval_launches}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(per_request == [1] * 8, "embedding_bag not launched once per "
                                  "serve_p99 request")
    check(retrieval_launches == 2, "embedding_bag not launched twice for "
                                   "the retrieval query")
    check(eb_launches == 11, f"embedding_bag launches {eb_launches} != 11")

    def plain_x0(batch):
        b = on_dev(batch)
        dense = b["dense"].to(cfg.dtype) * model.dense_norm["w"] \
            + model.dense_norm["b"]
        emb = eb_ref.ref_embedding_bag(table, flat_idx(b))
        return torch.cat([dense, emb.reshape(dense.shape[0], -1)], dim=-1)

    for i, (batch, logits) in enumerate(served):
        check(logits.shape == (512,) and bool(logits.isfinite().all()),
              f"serve_p99 request {i}: logits not finite")
        check(torch.equal(logits, recsys.tower(model, plain_x0(batch))),
              f"serve_p99 request {i}: logits differ from the plain route")
    check(bulk.shape == (shapes["serve_bulk"]["batch"],)
          and bool(bulk.isfinite().all()), "serve_bulk logits not finite")
    check(torch.equal(bulk, recsys.tower(model, plain_x0(host["serve_bulk"]))),
          "serve_bulk logits differ from the plain route")
    cand = torch.from_numpy(cand_host).to(dev)
    want = recsys.project_scores(
        model, recsys.cross_deep(model, plain_x0(host["retrieval_cand"])),
        eb_ref.ref_embedding_bag(table, cand[:, None]))
    check(scores.dtype == torch.float32 and scores.shape == cand.shape
          and bool(scores.isfinite().all()), "retrieval scores malformed")
    check(torch.equal(scores, want), "retrieval scores differ from the "
                                     "plain route")
    print(f"serving outputs: 8 x 512 logits, {bulk.shape[0]} bulk logits "
          f"and {scores.shape[0]} fp32 scores finite and bit-equal to the "
          "plain-lookup route")

    # -- 9. serving times ----------------------------------------------------
    req = host["serve_p99"]
    times = {
        "serve_p99_ms": time_ms(torch, lambda: cells["serve_p99"].step(
            model, req), reps=10),
        "serve_bulk_ms": time_ms(torch, lambda: cells["serve_bulk"].step(
            model, host["serve_bulk"])),
        "retrieval_cand_ms": time_ms(torch, lambda: cells[
            "retrieval_cand"].step(model, host["retrieval_cand"], cand_host),
            reps=5),
    }
    times["serve_bulk_samples_per_s"] = \
        shapes["serve_bulk"]["batch"] / times["serve_bulk_ms"] * 1e3
    print("recsys serving: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in times.items()))

    # -- 10. where the serving time goes -----------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for s in ("serve_p99", "serve_bulk", "retrieval_cand"):
        b = host[s]
        args = (b, cand_host) if s == "retrieval_cand" else (b,)
        bd = on_dev(b)
        x0 = recsys.interact(model, bd)
        parts = {
            "h2d_ms": time_ms(torch, lambda: (on_dev(b), torch.from_numpy(
                cand_host).to(dev) if len(args) == 2 else None)),
            "interact_ms": time_ms(torch, lambda: recsys.interact(model,
                                                                  bd)),
            "tower_ms": time_ms(torch, lambda: recsys.tower(model, x0)
                                if len(args) == 1 else recsys.project_scores(
                model, recsys.cross_deep(model, x0), eb_ops.embedding_bag(
                    table, cand[:, None]))),
        }
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                cells[s].step(model, *args)
            torch.cuda.synchronize()
        # device-side events only (kernels, copies): a CPU op's device
        # time repeats the time of the kernels it launched
        ev = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in ev) / 3e3
        kernel_ms = sum(e.self_device_time_total for e in ev
                        if not e.key.startswith("Mem")) / 3e3
        step_ms = times[f"{s}_ms"]
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
        parts.update(device_ms_per_step=device_ms,
                     kernel_ms_per_step=kernel_ms,
                     idle_share=1 - device_ms / step_ms if ev else None,
                     kernel_idle_share=1 - kernel_ms / step_ms if ev
                     else None,
                     top_device_ops={e.key[:60]: e.self_device_time_total
                                     / 3e3 for e in top})
        times[f"{s}_breakdown"] = parts
        print(f"breakdown {s}: {parts}")

    rows["embedding_bag"] = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:44",
        **eb["serve_bulk"], launches=eb_launches,
        also=[eb[k] for k in eb if k != "serve_bulk"])
    rows["segment_reduce"] = dict(
        name="segment_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:62",
        **sr["sum"], launches=sr_launches, also=[sr["min"], sr["max"]])
    return {"dcn-v2": times}


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

    # -- 6.-10. the recsys serving slice ------------------------------------
    e2e.update(recsys_phases(torch, np, dev, rows))
    print("e2e " + json.dumps(e2e))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rows[k] for k in (
        "cc_fused", "hook", "multi_jump", "embedding_bag",
        "segment_reduce")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
