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
fp32 order's error). This file imports no JAX, so it runs where only
PyTorch is installed.
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
from repro_torch.configs import dcn_v2
from repro_torch.models import recsys

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

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (7 stored mantissa bits)."""
    x = x.float().abs()
    e = torch.floor(torch.log2(torch.clamp(x, min=2.0 ** -126)))
    return torch.exp2(e - 7)


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
        assert bool((err <= bf16_ulp(want) + order).all())


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
        tol = tol + bf16_ulp(want)
    assert bool((err <= tol).all())


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
    bag and twice per mean bag; the logits match the plain-lookup route
    bit for bit."""
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
        assert sr_ops.KERNEL.launches == launches
        want = eb_ref.ref_embedding_bag(model.table, cand[:30].view(10, 3),
                                        combine)
        assert bool(((out.float() - want.float()).abs()
                     <= 2 * bf16_ulp(want)).all())
