"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where ``torch.cuda.is_available()``
is false (the kernels have no CPU mode). Run them on a machine with an
NVIDIA H100 (``sm_90a``) and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CC kernels do integer work: every comparison is exact (tolerance
0). The recsys kernels: a bag of 1 is a gather and min / max are exact,
all bit-equal; float32 sums are taken in another order by the kernel and
by torch, within the bound of two summation orders; a bfloat16 sum is an
fp32 sum rounded once on both sides, within one bfloat16 ulp (plus the
fp32 order's error). The flash-attention kernel: float32 within 1e-5 of
its plain version (fp32 sums in another order); bfloat16 inputs give
fp32 results of two orders, each rounded once, so within one bfloat16
ulp of the plain output plus that same 1e-5 -- for the FMA body, which
keeps P fp32 (float32, and bfloat16 at d = 16, 32). The Hopper body
(bfloat16 at d = 64, 128, 256) rounds P to bfloat16 for the PV product,
as the reference model's bfloat16 prefill does (``p.astype(v.dtype)``
into an fp32-accumulated product, ``repro/models/layers.py``), so its
gate is ``ref.p_rounding_bound``: one ulp of the plain output, plus
2^-8 (P @ |V|) for the rounding of each p by at most bfloat16's unit
roundoff, plus the 1e-5 order term. One ulp + 1e-5 cannot hold for any
kernel that rounds P, the reference's own bfloat16 paths included. That
per-element bound is a worst case, so the whole difference is also held
to the normwise ``ref.p_rounding_norm_bound``, which grows only as the
rounding errors' root-mean-square does.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import cc, rounds
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.core.unionfind import connected_components_scipy
from repro_torch.graphs.device import DeviceGraph
from repro_torch.graphs.generators import table1_scaled
from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
from repro_torch.kernels.hook import ops as hook_ops, ref as hook_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.multi_jump import ops as mj_ops, ref as mj_ref
from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.configs import dcn_v2, gemma2_2b, qwen2_5_32b
from repro_torch.models import recsys
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _forest(n: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    pi = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)
    return torch.from_numpy(pi).to(dev)


def _edges(n: int, e: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, n, (e, 2)).astype(np.int32)).to(dev)


def test_kernels_build(dev):
    kernels.build()
    for name in kernels.SOURCES:
        assert (kernels.build_dir() / f"lib{name}.so").exists()


@pytest.mark.parametrize("v,e,true,s", [(64, 200, 200, 3),
                                        (1000, 4096, 3000, 4),
                                        (5000, 5000, 5000, 1),
                                        (70000, 300000, 299999, 9)])
@pytest.mark.parametrize("lift", (0, 2))
def test_cc_fused_kernel_matches_plain(dev, v, e, true, s, lift):
    edges = _edges(v, e, seed=v + e, dev=dev)
    edges[true:] = 0
    plan = plan_segmentation(e, v, s)
    segs = rounds.pad_and_segment(edges, plan)
    counts = rounds.segment_true_counts(true, plan, device=dev)
    for pi0 in (torch.arange(v, dtype=torch.int32, device=dev),
                _forest(v, 3, dev)):
        got = cc_ops.fused_segment_scan(pi0, segs, counts, lift_steps=lift)
        want = cc_ref.ref_segment_scan(pi0, segs, counts, lift_steps=lift)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_cc_fused_kernel_exhausted_fuel_matches_plain(dev):
    n = 4000
    idx = torch.arange(n - 1, dtype=torch.int32, device=dev)
    edges = torch.stack([idx + 1, idx], 1).contiguous()
    plan = plan_segmentation(edges.shape[0], n, 3)
    segs = rounds.pad_and_segment(edges, plan)
    counts = rounds.segment_true_counts(edges.shape[0], plan, device=dev)
    pi0 = torch.arange(n, dtype=torch.int32, device=dev)
    for fuel in (1, 2, 3):
        got = cc_ops.fused_segment_scan(pi0, segs, counts, lift_steps=0,
                                        fuel=fuel)
        want = cc_ref.ref_segment_scan(pi0, segs, counts, lift_steps=0,
                                       fuel=fuel)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("tile", (1, 7, 256, 1024, 2000))
@pytest.mark.parametrize("lift", (0, 2))
def test_hook_kernel_matches_plain(dev, tile, lift):
    n, e = 3000, 10007
    pi, edges = _forest(n, tile, dev), _edges(n, e, seed=tile, dev=dev)
    got = hook_ops.hook_edges_pallas(pi, edges, edge_tile=tile,
                                     lift_steps=lift)
    pad = (-e) % tile
    padded = torch.cat([edges, edges.new_zeros((pad, 2))])
    want = hook_ref.ref_hook_tiled(pi, padded, tile, lift)
    assert torch.equal(got, want)
    # the CPU path of the same wrapper gives the same answer
    assert torch.equal(hook_ops.hook_edges_pallas(
        pi.cpu(), edges.cpu(), edge_tile=tile, lift_steps=lift), want.cpu())


@pytest.mark.parametrize("n,tile", ((512, 512), (1000, 128), (4099, 512),
                                    (300, 8), (5000, 2048)))
def test_multi_jump_kernel_matches_plain(dev, n, tile):
    pi = _forest(n, n, dev)
    got = mj_ops.multi_jump(pi, tile=tile, rounds=2)
    padded = torch.cat([pi, torch.arange(n, -(-n // tile) * tile,
                                         dtype=torch.int32, device=dev)])
    want = mj_ref.ref_multi_jump_sweep(padded, tile, 2)[:n]
    assert torch.equal(got, want)
    full = mj_ops.full_compress(pi, tile=tile)
    assert torch.equal(full, mj_ref.ref_multi_jump_sweeps(
        padded, tile, 2, 64)[:n])
    assert torch.equal(full, mj_ref.ref_full_compress(pi))


def _fixpoint_case(kind: str, n: int, dev) -> torch.Tensor:
    v = np.arange(n)
    pi = {"forest": lambda: np.minimum(v, np.random.default_rng(n).integers(
              0, n, n)),
          "chain": lambda: np.maximum(v - 1, 0),
          "reversed_chain": lambda: np.minimum(v + 1, n - 1),
          "star": lambda: np.zeros(n),
          "roots": lambda: v}[kind]()
    return torch.from_numpy(pi.astype(np.int32)).to(dev)


# forests of every tail length (V mod 4), chains of 2^20 vertices toward
# lower ids (as hooks build them) and toward higher ids, a star, all roots
FIXPOINT_CASES = ([("forest", n) for n in (1, 2, 3, 5, 1000, 4099, 100003)]
                  + [("chain", 2 ** 20), ("reversed_chain", 2 ** 20),
                     ("star", 2 ** 20), ("roots", 4096),
                     ("forest", 2 ** 22 + 1)])


@pytest.mark.parametrize("kind,n", FIXPOINT_CASES)
def test_full_compress_fixpoint_body_matches_plain(dev, kind, n):
    """full_compress's fixpoint body (one launch of compress_roots) is
    bit-equal to ref_full_compress and leaves its input alone."""
    pi = _fixpoint_case(kind, n, dev)
    keep = pi.clone()
    before = (mj_ops.ROOTS.launches, mj_ops.SEQUENTIAL.launches)
    got = mj_ops.full_compress(pi)
    want = mj_ref.ref_full_compress(pi)
    torch.cuda.synchronize()
    assert (mj_ops.ROOTS.launches, mj_ops.SEQUENTIAL.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, want)
    assert torch.equal(pi, keep)


@pytest.mark.parametrize("n", (8, 1001, 2 ** 20))
def test_full_compress_fixpoint_body_returns_on_a_cycle(dev, n):
    """A pi that is no forest (one cycle through every vertex, and short
    cycles beside a tree) still returns, within the body's 32 rounds,
    with every entry a vertex id."""
    v = torch.arange(n, dtype=torch.int32, device=dev)
    for pi in ((v + 1) % n, torch.where(v % 2 == 0, v + 1, v - 1)
               if n % 2 == 0 else torch.where(v < 3, (v + 1) % 3, v - 3)):
        got = mj_ops.full_compress(pi.to(torch.int32).contiguous())
        torch.cuda.synchronize()
        assert bool(((got >= 0) & (got < n)).all())


def test_wrappers_reject_bad_tensors(dev):
    pi = torch.arange(10, dtype=torch.int32, device=dev)
    edges = _edges(10, 6, 1, dev)
    with pytest.raises(ValueError):
        hook_ops.hook_edges_pallas(pi.long(), edges)
    with pytest.raises(ValueError):
        hook_ops.hook_edges_pallas(pi, edges.t())
    with pytest.raises(ValueError):
        mj_ops.full_compress(pi[::2])
    with pytest.raises(ValueError):
        cc_ops.fused_segment_scan(pi, edges[None].cpu(),
                                  torch.tensor([6], dtype=torch.int32))


@pytest.mark.parametrize("name", ("usa-osm", "soc-live-journal",
                                  "kron-logn21"))
def test_solves_on_card_match_oracle_and_counters(dev, name):
    g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1))
    assert g.device.type == "cuda"
    want = connected_components_scipy(g.edges.cpu().numpy(), g.num_nodes)
    adaptive = cc.solve_static(g, method="adaptive")
    before = cc_ops.KERNEL.launches
    fused = cc.solve_static(g, method="pallas_fused")
    launches = cc_ops.KERNEL.launches - before
    labels = cc.solve_pallas(g)
    np.testing.assert_array_equal(fused.labels.cpu().numpy(), want)
    np.testing.assert_array_equal(labels.cpu().numpy(), want)
    assert fused.work.as_ints() == adaptive.work.as_ints()
    cleanup = adaptive.work.as_ints()["hook_rounds"] - g.plan.num_segments
    assert launches == 1 + cleanup


# ---------------------------------------------------------------------------
# recsys kernels: embedding_bag and segment_reduce
# ---------------------------------------------------------------------------

def _table(rows: int, dim: int, dtype, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn((rows, dim), generator=g, device=dev).to(dtype)


# (vocab, dim, bags, bag): 16-byte vector rows (dim 16, 8), rows that
# take the scalar path (dim 5, 12 in bf16 / dim 6 in f32), the feature
# count as a bag, and a bag count that fills no whole block
EB_CASES = [(1000, 16, 4096, 1), (1000, 16, 777, 4), (300, 8, 256, 26),
            (500, 5, 300, 3), (200, 12, 1000, 1), (64, 6, 129, 8)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("combine", ("sum", "mean"))
@pytest.mark.parametrize("vocab,dim,bags,bag", EB_CASES)
def test_embedding_bag_kernel_matches_plain(dev, vocab, dim, bags, bag,
                                            combine, dtype):
    table = _table(vocab, dim, dtype, vocab + dim, dev)
    idx = _edges(vocab, bags * bag, seed=bags, dev=dev).view(-1)[
        :bags * bag].reshape(bags, bag).contiguous()
    before = eb_ops.KERNEL.launches
    got = eb_ops.embedding_bag(table, idx, combine=combine)
    want = eb_ref.ref_embedding_bag(table, idx, combine)
    torch.cuda.synchronize()
    assert eb_ops.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == (bags, dim)
    if bag == 1:
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs()
    sum_abs = table[idx.long()].float().abs().sum(1)
    if combine == "mean":
        sum_abs = sum_abs / bag
    order = 2 * bag * 2.0 ** -24 * sum_abs
    if dtype == torch.float32:
        assert bool((err <= order).all())
    else:
        assert bool((err <= fa_ref.ulp_bf16(want) + order).all())


def test_embedding_bag_kernel_unaligned_table(dev):
    """A table view that starts 4 bytes into its storage cannot take the
    16-byte vector path; the kernel falls back to scalar loads."""
    base = _table(201, 4, torch.float32, 1, dev)
    table = base.view(-1)[1:801].view(200, 4)
    idx = _edges(200, 64, 2, dev)
    got = eb_ops.embedding_bag(table, idx, combine="sum")
    want = eb_ref.ref_embedding_bag(table, idx, "sum")
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-6)


def test_embedding_bag_wrapper_rejects_bad_tensors(dev):
    table = _table(10, 8, torch.float32, 3, dev)
    idx = _edges(10, 4, 1, dev)
    with pytest.raises(ValueError):
        eb_ops.embedding_bag(table, idx.long())
    with pytest.raises(ValueError):
        eb_ops.embedding_bag(table.half(), idx)
    with pytest.raises(ValueError):
        eb_ops.embedding_bag(table, idx.t())
    with pytest.raises(ValueError):
        eb_ops.embedding_bag(table, idx.cpu())


# (n, d, segments): sorted and unsorted ids, a single segment, a 1-D
# case; ids run to segments + 2, and those past the end are dropped
SR_CASES = [(256, 16, 16, True), (1024, 32, 64, False), (512, 8, 1, True),
            (60000, 16, 13312, True), (1000, 1, 50, False)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("op", ("sum", "min", "max"))
@pytest.mark.parametrize("n,d,segs,sort", SR_CASES)
def test_segment_reduce_kernel_matches_plain(dev, n, d, segs, sort, op,
                                             dtype):
    data = _table(n, d, dtype, n + d, dev)
    if d == 1:
        data = data[:, 0].contiguous()
    ids = torch.randint(0, segs + 3, (n,), device=dev,
                        generator=torch.Generator(dev).manual_seed(n))
    ids = (torch.sort(ids).values if sort else ids).to(torch.int32)
    before = sr_ops.KERNEL.launches
    got = sr_ops.segment_reduce(data, ids, segs, op=op)  # ids >= segs drop
    want = sr_ref.ref_segment_reduce(data, ids, segs, op)
    torch.cuda.synchronize()
    assert sr_ops.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    if op != "sum":
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * (1 + want.float().abs())
    if dtype == torch.bfloat16:
        tol = tol + fa_ref.ulp_bf16(want)
    assert bool((err <= tol).all())


# (n, d, segments, offset): ids sorted and running from below 0 to past
# the last segment, so both ends drop rows; d = 1 (1-D), d = 3 (no
# 16-byte rows), the embedding bag's shape; offset 1 element leaves the
# data off 16-byte alignment (the body's scalar loads)
SR_SORTED_CASES = [(256, 16, 16, 0), (1000, 1, 50, 0), (999, 3, 40, 0),
                   (60000, 16, 13312, 0), (512, 8, 64, 1), (0, 16, 5, 0)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("op", ("sum", "min", "max"))
@pytest.mark.parametrize("n,d,segs,offset", SR_SORTED_CASES)
def test_segment_reduce_sorted_body_matches_plain(dev, n, d, segs, offset,
                                                  op, dtype):
    """The sorted body (one kernel): min / max bit-equal to plain, sums
    within the atomic body's gates and bit-equal from call to call."""
    flat = _table(n * d + offset, 1, dtype, n + d, dev)[:, 0]
    data = flat[offset:].view(n, d)
    if d == 1:
        data = data[:, 0]
    ids = torch.randint(-3, segs + 3, (n,), device=dev,
                        generator=torch.Generator(dev).manual_seed(n))
    ids = torch.sort(ids).values.to(torch.int32)
    before = (sr_ops.SORTED.launches, sr_ops.ATOMIC.launches)
    got = sr_ops.segment_reduce(data, ids, segs, op=op,
                                indices_are_sorted=True)
    again = sr_ops.segment_reduce(data, ids, segs, op=op,
                                  indices_are_sorted=True)
    want = sr_ref.ref_segment_reduce(data, ids, segs, op)
    torch.cuda.synchronize()
    assert (sr_ops.SORTED.launches, sr_ops.ATOMIC.launches) == (
        before[0] + 2, before[1])
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if op != "sum":
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * (1 + want.float().abs())
    if dtype == torch.bfloat16:
        tol = tol + fa_ref.ulp_bf16(want)
    assert bool((err <= tol).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_segment_reduce_sorted_body_is_one_kernel(dev, dtype):
    """torch.profiler sees exactly one CUDA kernel (and no memset or
    copy) per call of the sorted body, at the embedding bag's shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data = _table(60000, 16, dtype, 7, dev)
    ids = torch.sort(torch.randint(0, 13312, (60000,), device=dev,
                                   generator=torch.Generator(dev).manual_seed(
                                       7))).values.to(torch.int32)
    sr_ops.segment_reduce(data, ids, 13312, indices_are_sorted=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sr_ops.segment_reduce(data, ids, 13312, indices_are_sorted=True)
        torch.cuda.synchronize()
    ops = [(e.key, e.count) for e in prof.key_averages()
           if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    assert len(ops) == 1 and ops[0][1] == 1 and "sorted_kernel" in ops[0][0], ops


@pytest.mark.parametrize("op", ("sum", "min", "max"))
def test_segment_reduce_kernel_empty_input_and_segments(dev, op):
    data = torch.empty((0, 4), device=dev)
    ids = torch.empty((0,), dtype=torch.int32, device=dev)
    got = sr_ops.segment_reduce(data, ids, 3, op=op)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full((3, 4), sr_ref.reduce_identity(op),
                                       device=dev))


def test_recsys_path_launches_the_kernels(dev):
    """On CUDA tensors the recsys lookups go through the kernels: K5 once
    per forward and twice per retrieval query, K4 once per ragged sum
    bag and twice per mean bag, on its sorted body; the logits match the
    plain-lookup route bit for bit."""
    cfg = dataclasses.replace(
        dcn_v2.make_config(),
        table_sizes=tuple(min(s, 5000) for s in dcn_v2.make_config().
                          table_sizes))
    model = recsys.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s, 64) for s in cfg.table_sizes], 1)
    batch = {"dense": torch.from_numpy(rng.standard_normal(
        (64, 13)).astype(np.float32)).to(dev),
        "sparse_idx": torch.from_numpy(idx.astype(np.int32)).to(dev)}
    eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
    logits = recsys.forward(model, batch)
    assert eb_ops.KERNEL.launches == 1
    flat = (batch["sparse_idx"] + model.row_offsets).reshape(-1, 1)
    emb = eb_ref.ref_embedding_bag(model.table, flat).reshape(64, -1)
    x0 = recsys.interact(model, batch)
    assert torch.equal(x0[:, 13:], emb)
    assert torch.equal(logits, recsys.tower(model, x0))
    cand = torch.arange(1000, dtype=torch.int32, device=dev)
    eb_ops.KERNEL.launches = 0
    scores = recsys.retrieval_scores(
        model, {k: v[:1] for k, v in batch.items()}, cand)
    assert eb_ops.KERNEL.launches == 2
    assert scores.dtype == torch.float32 and scores.shape == (1000,)
    bag_ids = torch.arange(10, dtype=torch.int32, device=dev).repeat_interleave(3)
    for combine, launches in (("sum", 1), ("mean", 2)):
        sr_ops.KERNEL.launches = 0
        out = recsys.embedding_bag(model.table, cand[:30], bag_ids, 10,
                                   combine)
        assert sr_ops.KERNEL.launches == sr_ops.SORTED.launches == launches
        want = eb_ref.ref_embedding_bag(model.table, cand[:30].view(10, 3),
                                        combine)
        assert bool(((out.float() - want.float()).abs()
                     <= 2 * fa_ref.ulp_bf16(want)).all())


# (B, Sq = Sk, Hq, Hkv, d): ragged tails (no multiple of the 64-row
# or the 128-row tile), grouped heads (Hq / Hkv = 1, 2, 4, 5; 40 / 8 is
# qwen2.5-32b's grouping), B = 2, every head dim the kernel takes
FA_CASES = [(2, 100, 4, 2, 16), (1, 130, 8, 4, 256), (2, 77, 4, 4, 64),
            (1, 65, 2, 1, 128), (1, 50, 2, 2, 32), (3, 1, 4, 2, 64),
            (1, 129, 4, 4, 128), (1, 255, 4, 2, 256), (1, 200, 40, 8, 128),
            (2, 300, 10, 2, 64), (2, 255, 2, 2, 256)]
# (causal, window, softcap): a window smaller than one kv tile (16, 20,
# 33) and one longer than the sequence (4096), softcap 0, 30 and 50
FA_VARIANTS = [(True, 0, 0.0), (True, 16, 0.0), (True, 0, 30.0),
               (True, 33, 50.0), (False, 0, 0.0), (False, 20, 50.0),
               (True, 4096, 50.0)]


def _fa_check(q, k, v, body, **kw):
    """One kernel call against the plain version, under the body's gate:
    the Hopper body within ``p_rounding_bound`` element by element and
    within ``p_rounding_norm_bound`` as a whole, float32 within 1e-5,
    bfloat16 on the FMA body within one ulp + 1e-5. The body that
    ``body_of`` names must be the one that launched, once."""
    assert fa_ops.body_of(q.dtype, q.shape[-1]) is body
    before, total = body.launches, fa_ops.KERNEL.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    kw = dict(kw, sm_scale=q.shape[-1] ** -0.5)
    want = fa_ref.ref_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert body.launches == before + 1
    assert fa_ops.KERNEL.launches == total + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    if body is fa_ops.WGMMA:
        tol = fa_ref.p_rounding_bound(q, k, v, **kw)
        norm_tol = fa_ref.p_rounding_norm_bound(q, k, v, **kw)
        assert float(err.norm()) <= norm_tol, float(err.norm()) / norm_tol
    elif q.dtype == torch.float32:
        tol = 1e-5
    else:
        tol = fa_ref.ulp_bf16(want) + 1e-5
    assert bool(got.isfinite().all())
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("causal,window,cap", FA_VARIANTS)
@pytest.mark.parametrize("b,s,hq,hkv,d", FA_CASES)
def test_flash_attention_kernel_matches_plain(dev, b, s, hq, hkv, d, causal,
                                             window, cap, dtype):
    g = torch.Generator(dev).manual_seed(s * d + hq)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    body = fa_ops.WGMMA if dtype == torch.bfloat16 and d >= 64 else \
        fa_ops.FMA
    _fa_check(q, k, v, body, causal=causal, window=window, softcap=cap)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256)])
@pytest.mark.parametrize("causal,window,cap", [(True, 0, 50.0),
                                               (False, 0, 50.0),
                                               (False, 0, 0.0),
                                               (True, 70, 0.0)])
def test_flash_attention_kernel_longer_keys_than_queries(dev, dtype, d,
                                                        causal, window, cap):
    """Sk > Sq (ragged both): keys past the last query are masked by
    causality and, without it, read to Sk; on the Hopper body TMA's zero
    fill past Sk is masked by position."""
    g = torch.Generator(dev).manual_seed(d)
    q = torch.randn((2, 150, 6, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 333, 2, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    body = fa_ops.WGMMA if dtype == torch.bfloat16 else fa_ops.FMA
    _fa_check(q, k, v, body, causal=causal, window=window, softcap=cap)


def test_flash_attention_wrapper_rejects_bad_tensors(dev):
    q = torch.zeros((1, 8, 4, 16), device=dev)
    k = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(torch.zeros((1, 8, 4, 24), device=dev),
                               k[..., :12].repeat(1, 1, 1, 2),
                               k[..., :12].repeat(1, 1, 1, 2))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="one dtype"):
        fa_ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention(q, k.cpu(), k.cpu())


@pytest.mark.parametrize("mod", (gemma2_2b, qwen2_5_32b))
def test_smoke_engine_on_card_matches_port_on_cpu(dev, mod):
    """The smoke-config engine (float32) on the card gives the port's
    CPU tokens, and every prefill launches the kernel once per layer."""
    cfg = mod.make_smoke_config()
    params = T.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    # non-zero norm weights: at the reference's zero init qwen2.5's
    # logits are all 0
    g = torch.Generator().manual_seed(5)
    for name, t in T.flatten(params).items():
        if "ln" in name or name == "final_norm":
            t.normal_(0.0, 0.3, generator=g)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    on_dev = to_dev(params)
    outs = []
    for p in (params, on_dev):
        eng = E.Engine(p, cfg, slots=2, prompt_buf=16, cache_buf=40)
        rng = np.random.default_rng(4)
        for _ in range(5):
            eng.submit(rng.integers(1, cfg.vocab, int(rng.integers(3, 15))),
                       max_new=int(rng.integers(3, 8)))
        before = fa_ops.KERNEL.launches
        outs.append([(r.uid, r.out_tokens) for r in eng.run()])
        launches = fa_ops.KERNEL.launches - before
    assert launches == 5 * cfg.n_layers
    assert outs[1] == outs[0]
