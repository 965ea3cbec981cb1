#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. card and build: the card's name and power limit from ``nvidia-smi``;
   ``nvcc`` builds the six kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them, bit-equal (integer work, tolerance
   0), each timed with CUDA events (median of 3 after a warm-up); K3 on
   the main path's compress input of each graph (pi after segment 0's
   hook): ``full_compress``'s fixpoint body beside the sequential
   fixpoint body, both equal to ``ref_full_compress``, and the one-sweep
   ``multi_jump``;
3. the main path at full scale: ``solve_static(method="pallas_fused")``
   and ``solve_pallas`` on the Table I stand-ins usa-osm and kron-logn21
   at scale 1.0 (seed 1), with the launch counts of every kernel set to
   0 just before and read just after; labels equal the scipy oracle,
   ``pallas_fused`` WorkCounters equal the torch-ops ``adaptive`` solve,
   the fused kernel launches once per scan plus once per cleanup round,
   and every K3 launch is on the fixpoint body; then each solve once
   under ``torch.profiler``: every kernel's summed device time and
   launches;
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
   rows, launches counted, all on ``segment_reduce``'s sorted body) and
   both bodies of ``segment_reduce`` against its plain version on the
   gathered rows: sum within 1e-5 (1 + |ref|) in fp32 and one bfloat16
   ulp after the cast, min / max bit-equal, the sorted body's sum equal
   across two calls; timed per call over 20 back-to-back calls (a call
   this small costs its host work), beside ``index_add_`` (bf16, and
   fp32 then the cast: the same function) / ``scatter_reduce``, with
   each call's CUDA kernels and device time from ``torch.profiler`` (the
   sorted body: exactly one kernel);
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
    step time of phase 9;

then the LM serving slice, gemma2-2b at full width (26 layers, d_model
2304, 8 query / 4 kv heads of dim 256, vocab 256,000, bf16, random
weights from a seeded generator):

11. ``flash_attention`` against its plain version on the card. First
    the Hopper body as built: each instantiation's ptxas line
    (registers, spills: none allowed) and the HGMMA instructions in the
    library's SASS (``cuobjdump -sass``: at least one). Then, on the
    Hopper body (bfloat16, d = 64, 128, 256), within
    ``ref.p_rounding_bound`` of the fp32 plain output at every element
    (one ulp + 2^-8 (P @ |V|) + 1e-5: that body rounds P to bfloat16 for
    the PV product, as the reference model does) and within
    ``ref.p_rounding_norm_bound`` as a whole (that worst case grows with
    the row's length, the normwise bound does not): the actual layer-0
    (local, window 4096) and layer-1 (global) q, k, v of an 8192-token
    prefill;
    qwen2.5-32b's grouping at d = 128 (random [1, 8192, 40/8, 128],
    global, softcap 0); at the per-layer ``prefill_32k`` shape (B = 1,
    S = 32768) the last 256 query rows against the plain attention of
    those rows. On the FMA body: float32 at a small GQA shape within
    1e-5, bfloat16 at d = 32 within one bfloat16 ulp + 1e-5. Each row
    timed (CUDA events, median of 3 after a warm-up) with its achieved
    TFLOP/s, its share of the bound and the body that ran; at softcap 0
    and window 0 beside ``F.scaled_dot_product_attention``, at softcap
    50 beside ``flex_attention`` (compiled, a tanh softcap ``score_mod``
    and a causal / window block mask: the same function);
12. the serving path: ``Engine(slots=4, prompt_buf=8192,
    cache_buf=8256)`` serves six requests (prompts of 17 to 8192 tokens,
    two admitted mid-flight), the kernel's launch counts set to 0 just
    before and read just after (26 per prefill, all on the Hopper
    body); every emitted token within epsilon (8 bfloat16 ulps of the
    row's largest |logit|) of the argmax of the teacher-forced
    ``forward`` over prompt + emitted tokens; agreement with
    ``generate`` printed, not gated;
13. serving times: time to first token per prompt length (prefill plus
    splice), decode ms per step with 4 slots active, tokens/s over the
    run, the kernel's share of the prefill's device time and the decode
    step's device time and idle share from ``torch.profiler``, peak
    device memory.

It prints informative lines, then one JSON line of per-kernel numbers,
then, as its last line, ``{"ok": true, "device": {...}}``. Without a
CUDA device, or away from the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
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
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense tensor-core peak
SECTOR = 32                        # bytes a random 4-byte read costs in DRAM
K4_BATCH = 20                      # back-to-back calls per timing of K4
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


def time_ms(torch, fn, reps: int = 3, batch: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call, each
    over ``batch`` back-to-back calls and given per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
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


def float_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def top_device_ops(events, reps: int, n: int = 6) -> dict:
    """The ``n`` largest device ops, ms per repetition, by name cut to 60
    characters; ops whose cut names meet are summed, not overwritten."""
    ms = {}
    for e in events:
        ms[e.key[:60]] = ms.get(e.key[:60], 0.0) + \
            e.self_device_time_total / (1e3 * reps)
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def device_kernels(torch, fn, reps: int = 1) -> tuple[dict, float]:
    """Runs ``fn`` ``reps`` times under ``torch.profiler``. Returns
    ({kernel name cut to 60 characters: {"ms": summed device ms,
    "launches": count}} per repetition, the device time of all kernels
    and copies per repetition)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    out = {}
    for e in ev:
        k = out.setdefault(e.key[:60], {"ms": 0.0, "launches": 0})
        k["ms"] += e.self_device_time_total / (1e3 * reps)
        k["launches"] += e.count // reps
    total = sum(e.self_device_time_total for e in ev) / (1e3 * reps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"])), total


def kernel_share(per_kernel: dict, symbol: str) -> dict:
    """The summed device ms and launches of the kernels whose name holds
    ``symbol``."""
    hits = [v for k, v in per_kernel.items() if symbol in k]
    return {"ms": sum(v["ms"] for v in hits),
            "launches": sum(v["launches"] for v in hits)}


def recsys_phases(torch, np, dev, rows: dict) -> dict:
    """Phases 6-10: DCN-v2 at full width. Adds the ``embedding_bag`` and
    ``segment_reduce`` rows to ``rows``; returns the serving times."""
    import torch.nn.functional as F

    from repro_torch.configs import dcn_v2
    from repro_torch.data.pipeline import (make_stream, recsys_batch,
                                           recsys_batches)
    from repro_torch.kernels.embedding_bag import ops as eb_ops, \
        ref as eb_ref
    from repro_torch.kernels.flash_attention.ref import ulp_bf16
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
                      / ulp_bf16(want)).max())
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
    sr_bodies = {"sorted": sr_ops.SORTED.launches,
                 "atomic": sr_ops.ATOMIC.launches}
    check(sr_bodies["sorted"] == sr_launches,
          f"the ragged path did not take segment_reduce's sorted body: "
          f"{sr_bodies}")
    gathered = table[nnz_idx.long()]
    for c, got in ragged.items():
        want = sr_ref.ref_segment_reduce(gathered, bag_ids, num_bags, "sum")
        if c == "mean":
            cnt = torch.from_numpy(lengths).to(dev).to(want.dtype)
            want = want / cnt[:, None]
        ulps = float(((got.float() - want.float()).abs()
                      / ulp_bf16(want)).max())
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

    def per_call(fn) -> dict:
        """Device ops (kernels, and memsets or copies apart) and device
        ms per call of ``fn``, from torch.profiler over 3 calls."""
        per_kernel, total = device_kernels(torch, fn, reps=3)
        mem = sum(v["launches"] for k, v in per_kernel.items()
                  if k.startswith("Mem"))
        return {"cuda_kernels": sum(v["launches"] for v in
                                    per_kernel.values()) - mem,
                "memsets_or_copies": mem, "device_ms": total}

    sr = {}
    for op in ("sum", "min", "max"):
        # the sorted body (the path's), the atomic body, the plain version:
        # fp32 rows give the accumulator's own numbers, bf16 rows the cast
        calls = {
            "sorted": lambda x, op=op: sr_ops.segment_reduce(
                x, bag_ids, num_bags, op=op, indices_are_sorted=True),
            "atomic": lambda x, op=op: sr_ops.segment_reduce(
                x, bag_ids, num_bags, op=op),
            "plain": lambda x, op=op: sr_ref.ref_segment_reduce(
                x, bag_ids, num_bags, op)}
        out = {k: (f(gathered.float()), f(gathered))
               for k, f in calls.items()}
        again = calls["sorted"](gathered)
        torch.cuda.synchronize()
        want32, want = out["plain"]
        for body in ("sorted", "atomic"):
            got32, got = out[body]
            if op == "sum":
                check(bool(((got32 - want32).abs()
                            <= 1e-5 * (1 + want32.abs())).all()),
                      f"segment_reduce sum (fp32, {body}) out of tolerance")
                check(bool(((got.float() - want.float()).abs()
                            <= ulp_bf16(want)).all()),
                      f"segment_reduce sum (bf16, {body}) over 1 ulp")
            else:
                check(torch.equal(got32, want32) and torch.equal(got, want),
                      f"segment_reduce {op} ({body}) not bit-equal to plain")
        check(torch.equal(again, out["sorted"][1]),
              f"segment_reduce {op}: two calls of the sorted body differ")
        if op == "sum":
            library = lambda: torch.zeros(
                (num_bags, d), dtype=gathered.dtype, device=dev).index_add_(
                0, ids64, gathered)
            library32 = lambda: torch.zeros(
                (num_bags, d), dtype=torch.float32, device=dev).index_add_(
                0, ids64, gathered.float()).to(gathered.dtype)
        else:
            library = lambda op=op: torch.full(
                (num_bags, d), sr_ref.reduce_identity(op),
                dtype=gathered.dtype, device=dev).scatter_reduce_(
                0, ids2, gathered, "amin" if op == "min" else "amax")
            library32 = None
        ms_bound, by = bound(n * d * esize + 4 * n + num_bags * d * esize,
                             n * d)
        got32, got = out["sorted"]
        sr[op] = dict(
            op=op,
            shape=f"{op}: N={n} rows x {d} bf16 into S={num_bags} (ragged "
                  "bags of 1-8, sorted ids)",
            equal=torch.equal(got, want), max_abs_err=float_err(got, want),
            max_abs_err_fp32=float_err(got32, want32),
            atomic_max_abs_err=float_err(out["atomic"][1], want),
            deterministic=True,
            ms=time_ms(torch, lambda: calls["sorted"](gathered),
                       batch=K4_BATCH),
            atomic_ms=time_ms(torch, lambda: calls["atomic"](gathered),
                              batch=K4_BATCH),
            plain_ms=time_ms(torch, lambda: calls["plain"](gathered),
                             batch=K4_BATCH),
            library_ms=time_ms(torch, library, batch=K4_BATCH),
            library="index_add_ on a bf16 zeros" if op == "sum" else
                    "scatter_reduce_ on an identity-filled bf16 tensor",
            bound_ms=ms_bound, bound_by=by,
            per_call={"sorted": per_call(lambda: calls["sorted"](gathered)),
                      "atomic": per_call(lambda: calls["atomic"](gathered)),
                      "library": per_call(library)})
        if library32 is not None:
            sr[op].update(
                library_fp32_ms=time_ms(torch, library32, batch=K4_BATCH),
                library_fp32="index_add_ of fp32 rows on fp32 zeros, then "
                             "the cast to bf16 (the same function)")
            sr[op]["per_call"]["library_fp32"] = per_call(library32)
        check(sr[op]["per_call"]["sorted"]["cuda_kernels"] == 1,
              f"segment_reduce {op}: the sorted body ran "
              f"{sr[op]['per_call']['sorted']} per call, not one kernel")
        print(f"segment_reduce {op}: {sr[op]}")
    del gathered, ids2, ragged, out, again

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
        parts.update(device_ms_per_step=device_ms,
                     kernel_ms_per_step=kernel_ms,
                     idle_share=1 - device_ms / step_ms if ev else None,
                     kernel_idle_share=1 - kernel_ms / step_ms if ev
                     else None,
                     top_device_ops=top_device_ops(ev, 3))
        times[f"{s}_breakdown"] = parts
        print(f"breakdown {s}: {parts}")

    rows["embedding_bag"] = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:44",
        **eb["serve_bulk"], launches=eb_launches,
        also=[eb[k] for k in eb if k != "serve_bulk"])
    k4 = dict(route="cuda",
              source="src/repro_torch/kernels/csrc/segment_reduce.cu",
              replaces="src/repro/kernels/segment_reduce/segment_reduce.py:62")
    rows["segment_reduce"] = dict(
        name="segment_reduce", body="segment_reduce_sorted", **k4,
        **sr["sum"], launches=sr_bodies["sorted"],
        also=[sr["min"], sr["max"]])

    def atomic(row: dict) -> dict:
        return {**row, "shape": row["shape"].replace("sorted ids",
                                                     "the atomic body"),
                "body": "segment_reduce", "ms": row["atomic_ms"],
                "max_abs_err": row["atomic_max_abs_err"],
                "deterministic": row["op"] != "sum"}
    rows["segment_reduce_atomic"] = dict(
        name="segment_reduce_atomic", **k4, **atomic(sr["sum"]),
        launches=sr_bodies["atomic"],
        also=[atomic(sr["min"]), atomic(sr["max"])])
    return {"dcn-v2": times}


# LM serving slice (phases 11-13): the requests of phase 12, the buffers
# of its engine, the long prefill shape of phase 11
LM_PROMPTS = (17, 1000, 4095, 4097, 6000, 8192)
LM_MAX_NEW = (8, 32, 16, 32, 24, 32)
LM_PROMPT_BUF, LM_CACHE_BUF = 8192, 8256
LM_LONG = 32768
LM_TAIL = 256                      # rows of the long shape held to plain
LM_EPS_ULPS = 8                    # teacher-forced check, bf16 ulps


def attention_pairs(s: int, window: int) -> int:
    """Unmasked (q, k) pairs of causal attention over positions 0..s-1."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_flops(q, window: int) -> int:
    """4 d flops (QK and PV) per unmasked pair and query head."""
    b, s, hq, d = q.shape
    return 4 * d * hq * b * attention_pairs(s, window)


def attention_bound(q, k, window: int) -> tuple[float, str]:
    """The least time (ms) of one attention call: q, k, v, o moved once
    over the memory rate, its flops over the bf16 tensor-core peak."""
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * \
        k.element_size()
    by_bytes = bound_ms(nbytes)
    by_ops = attention_flops(q, window) / BF16_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def wgmma_build_report(torch, kernels) -> dict:
    """The Hopper attention body as built: each instantiation's ptxas
    lines (registers, spills) and the HGMMA instructions in the
    library's SASS. Fails on a spill or on SASS without HGMMA."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    lines = kernels.ptxas_report("flash_attention").splitlines()
    report = {}
    for i, line in enumerate(lines):
        if "Function properties for" in line and "flash_wgmma_kernel" in line:
            name = line.split("flash_wgmma_kernelILi")[1].split("E")[0]
            spill, regs = lines[i + 1].strip(), lines[i + 2].strip()
            regs = regs.removeprefix("ptxas info    : ")
            print(f"  ptxas flash_wgmma_kernel<{name}>: {spill}; {regs}")
            report[f"d{name}"] = f"{spill}; {regs}"
            check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"flash_wgmma_kernel<{name}> spills: {spill}")
    check(sorted(report) == sorted(f"d{d}" for d in fa_ops.WGMMA_HEAD_DIMS),
          f"ptxas report lacks a Hopper body: {sorted(report)}")
    for line in lines:
        if "Performance Loss" in line and "flash_wgmma" in line:
            print(f"  ptxas: {line.strip()}")
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    lib = kernels.build_dir() / "libflash_attention.so"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma = [ln.split()[1] for ln in sass.splitlines() if "HGMMA." in ln]
    kinds = sorted(set(hgmma))
    print(f"  SASS of libflash_attention.so: {len(hgmma)} HGMMA "
          f"instructions ({', '.join(kinds)})")
    check(len(hgmma) > 0, "no HGMMA instruction in the attention library")
    report["hgmma"] = len(hgmma)
    return report


def lm_phases(torch, np, dev, rows: dict, card: str) -> dict:
    """Phases 11-13: gemma2-2b serving at full width. Adds the
    ``flash_attention`` row to ``rows``; returns the serving numbers."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.configs import gemma2_2b
    from repro_torch.kernels.flash_attention import ops as fa_ops, \
        ref as fa_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    t0 = time.perf_counter()
    cfg = gemma2_2b.make_config()
    params = T.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    print(f"gemma2-2b: {T.param_count(cfg)} parameters, {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f} s")
    cap = cfg.attn_softcap

    def ulps(got, want):
        return (got.float() - want.float()).abs() / fa_ref.ulp_bf16(want)

    def check_close(got, want, what: str, bound=None,
                    norm_bound=None) -> dict:
        """Within ``bound`` at every element and within ``norm_bound`` in
        the 2-norm (the Hopper body's ``p_rounding_bound`` and
        ``p_rounding_norm_bound``) or, where none is given, within one
        bf16 ulp of plain plus the fp32 order term 1e-5 (the FMA
        body)."""
        err = (got.float() - want.float()).abs()
        u = ulps(got, want)
        gate = fa_ref.ulp_bf16(want) + 1e-5 if bound is None else bound
        res = dict(max_abs_err=float(err.max()), max_ulp=float(u.max()),
                   n_over_1_ulp=int((u > 1).sum()),
                   gate="1 bf16 ulp + 1e-5" if bound is None else
                   "p_rounding_bound and p_rounding_norm_bound",
                   max_err_over_gate=float((err / gate).max()),
                   finite=bool(got.isfinite().all()))
        ok = bool((err <= gate).all()) and res["finite"]
        if norm_bound is not None:
            res["norm_err_over_gate"] = float(err.norm()) / norm_bound
            ok = ok and res["norm_err_over_gate"] <= 1.0
        check(ok, f"flash_attention {what}: {res}")
        return res

    def flex_library(q, k, v, scale: float, window: int, softcap: float):
        """One call of ``flex_attention`` (compiled, not used by the
        port) for the same function: causal, the window as a block mask,
        cap * tanh(s / cap) as a ``score_mod``, GQA in place, on
        [B, H, S, d] copies. Returns (the call, its output as
        [B, S, H, d])."""
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def keep(b, h, qi, ki):
            return (qi >= ki) & (qi - ki < window) if window else qi >= ki

        def cap(score, b, h, qi, ki):
            return softcap * torch.tanh(score / softcap)

        mask = create_block_mask(keep, None, None, q.shape[1], k.shape[1],
                                 device=q.device)

        def call():
            return flex(qt, kt, vt, score_mod=cap, block_mask=mask,
                        scale=scale, enable_gqa=True)

        return call, call().transpose(1, 2)

    def add_flex(row: dict, call, out, want, bound) -> None:
        lib_ms = time_ms(torch, call)
        row.update(library_ms=lib_ms, library_ratio=row["ms"] / lib_ms,
                   library="flex_attention (torch.compile; tanh softcap "
                           "score_mod, causal / window block mask, "
                           "enable_gqa) on [B, H, S, d] copies",
                   library_max_err_over_gate=float(
                       ((out.float() - want.float()).abs() / bound).max()))

    def body(q) -> str:
        return "wgmma" if fa_ops.body_of(q.dtype, q.shape[-1]) is \
            fa_ops.WGMMA else "fma"

    def rates(q, window: int, ms: float, b_ms: float) -> dict:
        return dict(tflops=attention_flops(q, window) / ms / 1e9,
                    share_of_bound=b_ms / ms, body=body(q))

    # -- 11. flash_attention vs plain at the path's shapes -----------------
    from torch.nn.attention.flex_attention import create_block_mask, \
        flex_attention
    flex = torch.compile(flex_attention, dynamic=False)
    wgmma_build = wgmma_build_report(torch, kernels)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, LM_PROMPT_BUF)
    toks = torch.from_numpy(prompt.astype(np.int32)).to(dev)[None]
    captured = []
    launch = L.flash_attention

    def capture(q, k, v, **kw):
        captured.append((q, k, v, kw))
        return launch(q, k, v, **kw)

    L.flash_attention = capture
    try:
        T.forward_hidden({**params, "layers": params["layers"][:2]}, toks,
                         cfg)
    finally:
        L.flash_attention = launch
    check([c[3]["window"] for c in captured] == [cfg.window, 0],
          "layers 0 and 1 are not the local and global layer")
    fa = {}
    for name, (q, k, v, kw) in zip(("local_8192", "global_8192"), captured):
        got = fa_ops.flash_attention(q, k, v, **kw)
        pkw = dict(sm_scale=kw["sm_scale"], causal=True,
                   window=kw["window"], softcap=kw["softcap"])
        want = fa_ref.ref_flash_attention(q, k, v, **pkw)
        bound = fa_ref.p_rounding_bound(q, k, v, **pkw)
        norm_bound = fa_ref.p_rounding_norm_bound(q, k, v, **pkw)
        torch.cuda.synchronize()
        b_ms, by = attention_bound(q, k, kw["window"])
        ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, **kw))
        fa[name] = dict(
            shape=f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} bf16, "
                  f"window {kw['window']}, softcap {kw['softcap']}, layer "
                  f"{0 if kw['window'] else 1} of a {LM_PROMPT_BUF}-token "
                  "prefill",
            **check_close(got, want, name, bound, norm_bound), ms=ms,
            plain_ms=time_ms(torch, lambda: fa_ref.ref_flash_attention(
                q, k, v, **pkw)),
            bound_ms=b_ms, bound_by=by, **rates(q, kw["window"], ms, b_ms))
        add_flex(fa[name], *flex_library(q, k, v, kw["sm_scale"],
                                         kw["window"], kw["softcap"]),
                 want, bound)
        print(f"flash_attention {name} ({card}): {fa[name]}")
        del got, want, bound

    # softcap 0, window 0: the function scaled_dot_product_attention computes
    q, k, v, _ = captured[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.ref_flash_attention(q, k, v, sm_scale=scale)
    bound = fa_ref.p_rounding_bound(q, k, v, sm_scale=scale)
    norm_bound = fa_ref.p_rounding_norm_bound(q, k, v, sm_scale=scale)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    torch.cuda.synchronize()
    b_ms, by = attention_bound(q, k, 0)
    ms = time_ms(torch, lambda: fa_ops.flash_attention(q, k, v))
    fa["global_8192_nocap"] = dict(
        shape="global_8192_nocap: layer-1 q, k, v, window 0, softcap 0",
        **check_close(got, want, "global_8192_nocap", bound, norm_bound),
        library_max_ulp=float(ulps(lib, want).max()),
        library_max_err_over_gate=float(((lib.float() - want.float()).abs()
                                         / bound).max()),
        ms=ms,
        plain_ms=time_ms(torch, lambda: fa_ref.ref_flash_attention(
            q, k, v, sm_scale=scale)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) on [B, H, S, d] copies",
        bound_ms=b_ms, bound_by=by, **rates(q, 0, ms, b_ms))
    fa["global_8192_nocap"]["library_ratio"] = \
        ms / fa["global_8192_nocap"]["library_ms"]
    print(f"flash_attention global_8192_nocap ({card}): "
          f"{fa['global_8192_nocap']}")
    del captured, got, want, bound, lib, qt, kt, vt

    # qwen2.5-32b's grouping at head dim 128 (40 query / 8 kv heads),
    # random bf16, global, softcap 0, checked one kv head's group at a time
    g = torch.Generator(dev).manual_seed(4)
    qq = torch.randn((1, LM_PROMPT_BUF, 40, 128), generator=g,
                     device=dev).bfloat16()
    kq, vq = (torch.randn((1, LM_PROMPT_BUF, 8, 128), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    got = fa_ops.flash_attention(qq, kq, vq)
    groups = [(qq[:, :, 5 * h:5 * h + 5], kq[:, :, h:h + 1],
               vq[:, :, h:h + 1]) for h in range(8)]

    def by_group(fn):
        return torch.cat([fn(*x, sm_scale=128 ** -0.5) for x in groups],
                         dim=2)

    want = by_group(fa_ref.ref_flash_attention)
    bound = by_group(fa_ref.p_rounding_bound)
    # the groups' errors are disjoint, so their bounds add in squares
    norm_bound = sum(fa_ref.p_rounding_norm_bound(*x, sm_scale=128 ** -0.5)
                     ** 2 for x in groups) ** 0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kq, vq))
    b_ms, by = attention_bound(qq, kq, 0)
    ms = time_ms(torch, lambda: fa_ops.flash_attention(qq, kq, vq))
    fa["qwen_global_8192"] = dict(
        shape=f"qwen_global_8192: q {tuple(qq.shape)} k {tuple(kq.shape)} "
              "bf16 (random), window 0, softcap 0; the plain version one kv "
              "head's group at a time",
        **check_close(got, want, "qwen_global_8192", bound, norm_bound),
        ms=ms,
        plain_ms=time_ms(torch, lambda: by_group(
            fa_ref.ref_flash_attention)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) on [B, H, S, d] copies",
        bound_ms=b_ms, bound_by=by, **rates(qq, 0, ms, b_ms))
    fa["qwen_global_8192"]["library_ratio"] = \
        ms / fa["qwen_global_8192"]["library_ms"]
    print(f"flash_attention qwen_global_8192 ({card}): "
          f"{fa['qwen_global_8192']}")
    del qq, kq, vq, got, want, bound, groups, qt, kt, vt

    # the FMA body: float32 at a small GQA shape with ragged tails within
    # 1e-5, bfloat16 at head dim 32 within one ulp + 1e-5
    g = torch.Generator(dev).manual_seed(2)
    q32, k32, v32 = (torch.randn((2, 300, h, 256), generator=g, device=dev)
                     for h in (8, 4, 4))
    for window in (0, 64):
        got = fa_ops.flash_attention(q32, k32, v32, window=window,
                                     softcap=cap)
        want = fa_ref.ref_flash_attention(q32, k32, v32, sm_scale=1 / 16,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"flash_attention f32 window {window}: {err}")
        print(f"flash_attention f32 [2, 300, 8/4, 256] window {window} "
              f"(body {body(q32)}): "
              f"max_abs_err {err}")
    qs, ks, vs = (torch.randn((2, 300, h, 32), generator=g,
                              device=dev).bfloat16() for h in (8, 4, 4))
    for window in (0, 64):
        got = fa_ops.flash_attention(qs, ks, vs, window=window, softcap=cap)
        want = fa_ref.ref_flash_attention(qs, ks, vs, sm_scale=32 ** -0.5,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        res = check_close(got, want, f"bf16 d32 window {window}")
        print(f"flash_attention bf16 [2, 300, 8/4, 32] window {window} "
              f"(body {body(qs)}): {res}")
    del q32, k32, v32, qs, ks, vs

    # the per-layer prefill_32k shape, the tail held to plain
    g = torch.Generator(dev).manual_seed(3)
    ql = torch.randn((1, LM_LONG, 8, 256), generator=g, device=dev).bfloat16()
    kl, vl = (torch.randn((1, LM_LONG, 4, 256), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    for name, window, c in (("local_32768", cfg.window, cap),
                            ("global_32768", 0, cap),
                            ("global_32768_nocap", 0, 0.0)):
        got = fa_ops.flash_attention(ql, kl, vl, window=window, softcap=c)
        tkw = dict(sm_scale=256 ** -0.5, window=window, softcap=c,
                   q_offset=LM_LONG - LM_TAIL)
        want = fa_ref.ref_flash_attention(ql[:, -LM_TAIL:], kl, vl, **tkw)
        bound = fa_ref.p_rounding_bound(ql[:, -LM_TAIL:], kl, vl, **tkw)
        norm_bound = fa_ref.p_rounding_norm_bound(ql[:, -LM_TAIL:], kl, vl,
                                                  **tkw)
        torch.cuda.synchronize()
        b_ms, by = attention_bound(ql, kl, window)
        ms = time_ms(torch, lambda: fa_ops.flash_attention(
            ql, kl, vl, window=window, softcap=c))
        fa[name] = dict(
            shape=f"{name}: q {tuple(ql.shape)} k {tuple(kl.shape)} bf16 "
                  f"(random), window {window}, softcap {c}; last {LM_TAIL} "
                  "rows held to plain",
            **check_close(got[:, -LM_TAIL:], want, name, bound,
                          norm_bound), ms=ms,
            plain_ms=None, plain="not measured: the plain score matrix "
                                 "would take 34 GB",
            bound_ms=b_ms, bound_by=by, **rates(ql, window, ms, b_ms),
            library_ms=None)
        if c > 0:
            call, out = flex_library(ql, kl, vl, 256 ** -0.5, window, c)
            add_flex(fa[name], call, out[:, -LM_TAIL:], want, bound)
            del call, out
        elif window == 0:
            qt, kt, vt = (x.transpose(1, 2).contiguous()
                          for x in (ql, kl, vl))
            fa[name]["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            fa[name]["library_ratio"] = ms / fa[name]["library_ms"]
            del qt, kt, vt
        print(f"flash_attention {name} ({card}): {fa[name]}")
        del got, want, bound
    del ql, kl, vl

    # -- 12. the serving path at full width, launches counted --------------
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    eng = E.Engine(params, cfg, slots=4, prompt_buf=LM_PROMPT_BUF,
                   cache_buf=LM_CACHE_BUF)
    for p, n in zip(prompts, LM_MAX_NEW):
        eng.submit(p, max_new=n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fa_launches = fa_ops.KERNEL.launches
    fa_bodies = {"wgmma": fa_ops.WGMMA.launches, "fma": fa_ops.FMA.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tokens = sum(len(r.out_tokens) for r in done)
    print(f"serving run ({card}): {len(done)} requests, {n_tokens} tokens in "
          f"{run_s:.2f} s; flash_attention launches {fa_launches} "
          f"(by body {fa_bodies}); peak "
          f"device memory {peak:.2f} GiB")
    check(len(done) == len(LM_PROMPTS), "not every request finished")
    check(fa_launches == cfg.n_layers * len(LM_PROMPTS),
          f"flash_attention launched {fa_launches} times, expected "
          f"{cfg.n_layers} per prefill")
    check(fa_bodies["wgmma"] == fa_launches,
          f"not every prefill attention took the Hopper body: {fa_bodies}")
    by_uid = sorted(done, key=lambda r: r.uid)
    worst, agree = 0.0, []
    for r in by_uid:
        out = np.asarray(r.out_tokens, np.int32)
        check(len(out) == r.max_new and bool(((out >= 0) & (
            out < cfg.padded_vocab)).all()), f"request {r.uid} tokens")
        seq = np.concatenate([r.prompt, out[:-1]])
        logits = T.forward(params, torch.from_numpy(seq).to(dev)[None],
                           cfg)[0, len(r.prompt) - 1:]
        check(bool(logits.isfinite().all()), f"request {r.uid}: logits "
                                             "not finite")
        top = logits.max(dim=-1).values
        chosen = logits[torch.arange(len(out), device=dev),
                        torch.from_numpy(out).long().to(dev)]
        margin = (top - chosen) / fa_ref.ulp_bf16(logits.abs().max(
            dim=-1).values)
        worst = max(worst, float(margin.max()))
        check(bool((margin <= LM_EPS_ULPS).all()),
              f"request {r.uid}: a token {float(margin.max())} bf16 ulps "
              "below the teacher-forced argmax")
        del logits
        gen = E.generate(params, cfg, r.prompt[None], max_new=len(out))[0]
        agree.append(float((gen == out).mean()))
    print(f"teacher-forced check: every token within {LM_EPS_ULPS} bf16 "
          f"ulps of the argmax; worst margin {worst:.3f} ulps; agreement "
          f"with generate per request {agree}")

    # -- 13. serving times --------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ttft = {}
    for p in prompts:
        def first_token(p=p):
            toks = np.zeros((1, LM_PROMPT_BUF), np.int32)
            toks[0, :len(p)] = p
            one = T.init_cache(cfg, 1, LM_CACHE_BUF, device=dev)
            logits, one = E._prefill(
                params, torch.from_numpy(toks).to(dev), one,
                torch.tensor([len(p)], dtype=torch.int32, device=dev), cfg)
            E._void_padding(one, [len(p)])
            E._splice(eng.cache, one, 0)
            return int(E.greedy(logits[:, len(p) - 1])[0])
        ttft[len(p)] = time_ms(torch, first_token)
    lengths = torch.tensor([LM_PROMPTS[i] + LM_MAX_NEW[i] for i in
                            range(4)], dtype=torch.int32, device=dev)
    last = torch.zeros(4, dtype=torch.int32, device=dev)

    def decode_step():
        logits, _ = E._decode(params, last, eng.cache, lengths, cfg)
        return E.greedy(logits).cpu()
    decode_ms = time_ms(torch, decode_step, reps=10)
    toks = np.zeros((1, LM_PROMPT_BUF), np.int32)

    def prefill():
        E._prefill(params, torch.from_numpy(toks).to(dev),
                   T.init_cache(cfg, 1, LM_CACHE_BUF, device=dev),
                   torch.tensor([LM_PROMPT_BUF], dtype=torch.int32,
                                device=dev), cfg)

    def device_profile(fn, reps: int):
        """Device time per call of ``fn`` (kernels and copies, device-side
        events only), that of the flash kernel, and the top ops."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in ev) / (1e3 * reps)
        flash = sum(e.self_device_time_total for e in ev
                    if "flash_wgmma_kernel" in e.key
                    or "flash_kernel" in e.key) / (1e3 * reps)
        return total, flash, top_device_ops(ev, reps)

    device_ms, flash_ms, top_prefill = device_profile(prefill, 1)
    decode_device_ms, _, top_decode = device_profile(decode_step, 3)
    times = {
        "ttft_ms": ttft, "decode_ms_per_step_4_slots": decode_ms,
        "run_s": run_s, "tokens": n_tokens, "tokens_per_s": n_tokens / run_s,
        "prefill_device_ms": device_ms, "prefill_flash_ms": flash_ms,
        "flash_share_of_prefill": flash_ms / device_ms if device_ms else None,
        "prefill_top_device_ops": top_prefill,
        "decode_device_ms_per_step": decode_device_ms,
        "decode_idle_share": 1 - decode_device_ms / decode_ms,
        "decode_top_device_ops": top_decode,
        "peak_gib": peak, "worst_margin_ulps": worst,
        "generate_agreement": agree, "card": card}
    print(f"lm serving ({card}): {times}")

    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:102",
        **fa["global_8192_nocap"], launches=fa_launches,
        launches_by_body=fa_bodies, build=wgmma_build,
        also=[fa[k] for k in fa if k != "global_8192_nocap"])
    return {"gemma2-2b": times}


def main() -> int:
    # the one torch.compile (phase 11's flex_attention yardstick) keeps
    # its caches in the checkout's build directory and compiles in-process
    for var, val in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "inductor"),
                     ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                     ("TORCHINDUCTOR_COMPILE_THREADS", "1")):
        os.environ.setdefault(var, str(val))
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

    # K3 on the main path's compress input, pi after the first segment's
    # hook, on both graphs: full_compress (the fixpoint body) beside the
    # one-block sequential body run to its fixpoint (tile 512, 2 rounds,
    # at most 64 sweeps)
    mj, seq_mj = {}, {}
    for name, g in graphs.items():
        pi0 = torch.arange(g.num_nodes, dtype=torch.int32, device=dev)
        hooked = rounds.hook_edges(pi0, scans[name][0][0], lift_steps=2)
        want = mj_ref.ref_full_compress(hooked)
        got = mj_ops.full_compress(hooked, tile=512)
        seq = mj_ops.sequential_sweeps(hooked, tile=512, rounds=2,
                                       max_sweeps=mj_ops.MAX_SWEEPS)
        torch.cuda.synchronize()
        err = max(max_abs_err(got, want), max_abs_err(seq, want))
        check(err == 0, f"full_compress or the sequential fixpoint differs "
                        f"from ref_full_compress on {name}")
        moved = int((hooked != want).sum())
        v = g.num_nodes
        shape = (f"{name} full_compress: V={v}, pi after segment 0's hook "
                 f"({moved} pointers move)")
        common = dict(equal=True, max_abs_err=err,
                      plain_ms=time_ms(torch, lambda: mj_ref.ref_full_compress(
                          hooked)),
                      bound_ms=bound_ms(8 * v), bound_by="bytes",
                      bound_sector_ms=bound_ms((8 + SECTOR) * v),
                      library_ms=None)
        mj[name] = dict(
            shape=shape, body="compress_roots", **common,
            ms=time_ms(torch, lambda: mj_ops.full_compress(hooked, tile=512)))
        seq_mj[name] = dict(
            shape=shape + "; tile 512, 2 rounds, at most 64 sweeps",
            body="multi_jump_sweeps", **common,
            ms=time_ms(torch, lambda: mj_ops.sequential_sweeps(
                hooked, tile=512, rounds=2, max_sweeps=mj_ops.MAX_SWEEPS)))
        mj[name]["speedup_over_sequential"] = \
            seq_mj[name]["ms"] / mj[name]["ms"]
        print(f"multi_jump {name} ({card}): fixpoint body {mj[name]}; "
              f"sequential body {seq_mj[name]}")

    # the one-sweep body (multi_jump), off the main path
    g = graphs["kron-logn21"]
    hooked = rounds.hook_edges(
        torch.arange(g.num_nodes, dtype=torch.int32, device=dev),
        scans["kron-logn21"][0][0], lift_steps=2)
    got = mj_ops.multi_jump(hooked, tile=512, rounds=2)
    want = mj_ref.ref_multi_jump_sweep(hooked, 512, 2)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "multi_jump differs from its plain version on kron")
    seq_mj["one_sweep"] = dict(
        shape=f"kron-logn21 one sweep: V={g.num_nodes}, tile 512, rounds 2",
        body="multi_jump_sweeps", equal=True, max_abs_err=err,
        ms=time_ms(torch, lambda: mj_ops.multi_jump(hooked, tile=512)),
        plain_ms=time_ms(torch, lambda: mj_ref.ref_multi_jump_sweep(
            hooked, 512, 2)),
        bound_ms=bound_ms(8 * g.num_nodes), bound_by="bytes",
        bound_sector_ms=bound_ms((8 + 2 * SECTOR) * g.num_nodes),
        library_ms=None)
    print(f"multi_jump one sweep ({card}): {seq_mj['one_sweep']}")
    k3 = dict(route="cuda", source="src/repro_torch/kernels/csrc/multi_jump.cu",
              replaces="src/repro/kernels/multi_jump/multi_jump.py:56")
    rows["multi_jump"] = dict(name="multi_jump", **k3, **mj["usa-osm"],
                              also=[mj["kron-logn21"]])
    rows["multi_jump_sequential"] = dict(
        name="multi_jump_sequential", **k3, **seq_mj["usa-osm"],
        also=[seq_mj["kron-logn21"], seq_mj["one_sweep"]])
    del hooked, got, want, seq

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
    mj_bodies = {"roots": mj_ops.ROOTS.launches,
                 "sequential": mj_ops.SEQUENTIAL.launches}
    check(mj_bodies["roots"] == launches["multi_jump"],
          f"full_compress did not take the fixpoint body: {mj_bodies}")
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
    for k in ("cc_fused", "hook"):
        rows[k]["launches"] = launches[k]
    rows["multi_jump"]["launches"] = mj_bodies["roots"]
    rows["multi_jump_sequential"]["launches"] = mj_bodies["sequential"]
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where each solve's device time goes: every kernel's summed device
    # time and launches over one solve, from torch.profiler
    symbols = {"cc_fused": "cc_fused_kernel", "hook": "hook_tiles_kernel",
               "multi_jump": "compress_roots_kernel",
               "multi_jump_sequential": "multi_jump_kernel"}
    for name, g in graphs.items():
        for solve, fn in (("pallas", lambda: cc.solve_pallas(g)),
                          ("pallas_fused", lambda: cc.solve_static(
                              g, method="pallas_fused"))):
            per_kernel, total = device_kernels(torch, fn)
            shares = {k: kernel_share(per_kernel, sym)
                      for k, sym in symbols.items()}
            print(f"profile {name} {solve} ({card}): device {total:.3f} ms; "
                  f"CC kernels {shares}; top "
                  f"{dict(list(per_kernel.items())[:6])}")
            for k, share in shares.items():
                rows[k].setdefault("main_path_device_ms", {})[
                    f"{name} {solve}"] = share

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

    # -- 11.-13. the LM serving slice -----------------------------------------
    e2e.update(lm_phases(torch, np, dev, rows, card))
    print("e2e " + json.dumps(e2e))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rows[k] for k in (
        "cc_fused", "hook", "multi_jump", "multi_jump_sequential",
        "embedding_bag", "segment_reduce", "segment_reduce_atomic",
        "flash_attention")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
