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
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import autograd as ag
from repro_torch.core import cc, rounds
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.core.unionfind import connected_components_scipy
from repro_torch.graphs.device import DeviceGraph
from repro_torch.graphs.generators import rmat, table1_scaled
from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref
from repro_torch.kernels.hook import ops as hook_ops, ref as hook_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.multi_jump import ops as mj_ops, ref as mj_ref
from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.configs import dcn_v2, gemma2_2b, grok_1_314b, \
    minicpm3_4b, phi3_5_moe, qwen2_5_32b
from repro_torch.models import layers as L
from repro_torch.models import moe as M
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


def _bucket(batch: int, v_pad: int, segments: int, seg: int, seed: int,
            dev):
    """A bucket's batched-scan inputs: random local-id segments, per-graph
    counts from 0 to seg (some graphs empty), pi random forests."""
    rng = np.random.default_rng(seed)
    segs = rng.integers(0, v_pad, (batch, segments, seg, 2))
    counts = rng.integers(0, seg + 1, (batch, segments))
    counts[::7] = 0
    pi = np.minimum(np.arange(v_pad), rng.integers(0, v_pad, (batch, v_pad)))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (pi, segs, counts))


def _body_kernel(v_pad: int):
    """The launch count of the batched body a bucket of V_pad takes."""
    return cc_ops.BLOCK if cc_ops.batched_body(v_pad) == "block" \
        else cc_ops.GRID


@pytest.mark.parametrize("v_pad,batch,segments,seg", [
    (8, 300, 3, 8), (64, 100, 4, 50), (256, 40, 2, 300),
    (4096, 10, 5, 2000), (16, 400, 4, 24), (32, 320, 3, 96),
    (64, 300, 2, 128), (16384, 3, 2, 20000), (32768, 3, 2, 20000)])
@pytest.mark.parametrize("lift", (0, 2))
def test_cc_fused_batched_kernel_matches_plain(dev, v_pad, batch, segments,
                                               seg, lift):
    """The batched entry equals ``ref_segment_scan_batched`` (pi and the
    per-graph sweeps) on molecule-sized buckets (V_pad 8-64, B 100-400),
    medium ones, at the block body's limit (V_pad 16,384) and at twice
    it (the grid body), from identity and from random forests; one
    launch per call, on the body ``batched_body`` names."""
    pi, segs, counts = _bucket(batch, v_pad, segments, seg, v_pad + lift,
                               dev)
    body = _body_kernel(v_pad)
    assert (body is cc_ops.BLOCK) == (v_pad <= 16384)
    for pi0 in (torch.arange(v_pad, dtype=torch.int32, device=dev)
                .expand(batch, v_pad).contiguous(), pi):
        before = (cc_ops.BATCHED.launches, body.launches)
        got = cc_ops.fused_segment_scan_batched(pi0, segs, counts,
                                                lift_steps=lift)
        want = cc_ref.ref_segment_scan_batched(pi0, segs, counts,
                                               lift_steps=lift)
        torch.cuda.synchronize()
        assert (cc_ops.BATCHED.launches, body.launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_cc_fused_batched_kernel_exhausted_fuel_matches_plain(dev):
    """Chains that need more sweeps than the fuel gives, beside graphs
    that converge at once: the per-graph sweep counts stop at the fuel,
    on the block body (V_pad 1024) and on the grid body (32,768)."""
    for v_pad in (1024, 32768):
        batch = 6
        idx = np.arange(v_pad - 1)
        chain = np.stack([idx + 1, idx], 1)
        segs = np.zeros((batch, 1, v_pad - 1, 2), np.int64)
        segs[::2, 0] = chain
        segs = torch.from_numpy(segs.astype(np.int32)).to(dev)
        counts = torch.full((batch, 1), v_pad - 1, dtype=torch.int32,
                            device=dev)
        pi0 = torch.arange(v_pad, dtype=torch.int32, device=dev) \
            .expand(batch, v_pad).contiguous()
        body = _body_kernel(v_pad)
        for fuel in (1, 2, 3, 20):
            before = body.launches
            got = cc_ops.fused_segment_scan_batched(pi0, segs, counts,
                                                    lift_steps=0, fuel=fuel)
            want = cc_ref.ref_segment_scan_batched(pi0, segs, counts,
                                                   lift_steps=0, fuel=fuel)
            assert body.launches == before + 1
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_solve_batch_on_the_card_matches_the_cpu(dev):
    """``Solver.solve_batch`` on CUDA gives the CPU run's labels and
    counters, launching the batched scan once per bucket plus once per
    cleanup round."""
    from repro_torch.api import Solver
    from repro_torch.graphs.generators import rmat
    graphs = [rmat(5 + i % 4, 6, seed=i) for i in range(40)]
    cc_ops.BATCHED.launches = 0
    got = Solver.solve_batch(graphs)
    launches = cc_ops.BATCHED.launches
    want = Solver.solve_batch(graphs, device="cpu")
    buckets = {(g.num_nodes, g.num_edges) for g in graphs}
    assert launches >= len(buckets)
    for a, b in zip(got, want):
        assert a.labels.device.type == "cpu"
        assert torch.equal(a.labels, b.labels)
        assert [int(x) for x in a.work] == [int(x) for x in b.work]
    dgs = [DeviceGraph.from_host(g, device=dev) for g in graphs[:8]]
    on_card = Solver.solve_batch(dgs)
    assert all(r.labels.is_cuda for r in on_card)
    for a, b in zip(on_card, want[:8]):
        assert torch.equal(a.labels.cpu(), b.labels)


@pytest.mark.parametrize("tile", (1, 7, 256, 1000, 1024, 2000, 6144))
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


def _storm(kind: str, n: int, e: int, dev):
    """(pi, edges) where every hook lands on one address: ``consistent``,
    every vertex already under root 0 (every atomic a no-op); ``hub``,
    every edge (u, n - 1) on the identity (real work on one hi)."""
    edges = _edges(n, e, seed=e, dev=dev)
    if kind == "consistent":
        return torch.zeros(n, dtype=torch.int32, device=dev), edges
    edges[:, 1] = n - 1
    return torch.arange(n, dtype=torch.int32, device=dev), edges


@pytest.mark.parametrize("case", ("forest", "consistent", "hub"))
@pytest.mark.parametrize("n,e", ((3000, 10007), (100000, 2000003)))
@pytest.mark.parametrize("lift", (0, 1, 2))
def test_hook_snapshot_kernel_matches_plain(dev, case, n, e, lift):
    """The snapshot body (every SM) is bit-equal to ``hook_edges`` (one
    snapshot) and leaves its input alone, on random forests and on the
    single-address storms; so is the one-block tiled body at one tile
    where that fits its shared memory."""
    if case == "forest":
        pi, edges = _forest(n, e + lift, dev), _edges(n, e, seed=n, dev=dev)
    else:
        pi, edges = _storm(case, n, e, dev)
    keep = pi.clone()
    before = (hook_ops.SNAPSHOT.launches, hook_ops.TILES.launches)
    got = hook_ops.hook_edges_snapshot(pi, edges, lift_steps=lift)
    want = rounds.hook_edges(pi, edges, lift_steps=lift)
    torch.cuda.synchronize()
    assert (hook_ops.SNAPSHOT.launches, hook_ops.TILES.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, want)
    assert torch.equal(pi, keep)
    assert torch.equal(want, hook_ref.ref_hook_round(pi, edges, lift))
    if case != "forest":
        tiled = hook_ops.hook_edges_pallas(pi, edges, edge_tile=1000,
                                           lift_steps=lift)
        pad = (-e) % 1000
        padded = torch.cat([edges, edges.new_zeros((pad, 2))])
        assert torch.equal(tiled, hook_ref.ref_hook_tiled(pi, padded, 1000,
                                                          lift))


@pytest.mark.parametrize("case", ("consistent", "hub", "kron"))
@pytest.mark.parametrize("lift", (0, 2))
def test_cc_fused_kernel_on_single_address_storms_matches_plain(dev, case,
                                                                 lift):
    """The fused scan's no-op skip keeps pi and every segment's sweep
    count bit-equal to plain where the hooks of a segment meet one
    address: the storms above in 8 segments, and the kron-logn21
    stand-in at scale 0.02 (its hub roots)."""
    if case == "kron":
        g = DeviceGraph.from_host(table1_scaled("kron-logn21", scale=0.02,
                                                seed=1))
        n, edges, plan, true = g.num_nodes, g.edges, g.plan, g.true_edges
        pi0 = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        n = 100000
        pi0, edges = _storm(case, n, 2000000, dev)
        plan, true = plan_segmentation(edges.shape[0], n, 8), edges.shape[0]
    segs = rounds.pad_and_segment(edges, plan)
    counts = rounds.segment_true_counts(true, plan, device=dev)
    got = cc_ops.fused_segment_scan(pi0, segs, counts, lift_steps=lift)
    want = cc_ref.ref_segment_scan(pi0, segs, counts, lift_steps=lift)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    # and the cleanup launch: the whole edge list as one segment
    true1 = torch.tensor([true], dtype=torch.int32, device=dev)
    flat = segs.reshape(1, -1, 2)
    got = cc_ops.fused_segment_scan(want[0], flat, true1, lift_steps=lift)
    want = cc_ref.ref_segment_scan(want[0], flat, true1, lift_steps=lift)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


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
        hook_ops.hook_edges_snapshot(pi.long(), edges)
    with pytest.raises(ValueError):
        hook_ops.hook_edges_snapshot(pi, edges.t())
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
    hook_ops.KERNEL.launches = 0
    labels = cc.solve_pallas(g)
    np.testing.assert_array_equal(fused.labels.cpu().numpy(), want)
    np.testing.assert_array_equal(labels.cpu().numpy(), want)
    assert fused.work.as_ints() == adaptive.work.as_ints()
    hook_rounds = adaptive.work.as_ints()["hook_rounds"]
    cleanup = hook_rounds - g.plan.num_segments
    assert launches == 1 + cleanup
    # solve_pallas hooks on the snapshot body, once per adaptive hook round
    assert hook_ops.SNAPSHOT.launches == hook_ops.KERNEL.launches == \
        hook_rounds


# ---------------------------------------------------------------------------
# the front door: forest, sampled engines, Solver, queries
# ---------------------------------------------------------------------------

STANDINS = ("usa-osm", "euro-osm-karls", "soc-live-journal", "kron-logn21")


def _on_both(name: str, dev):
    host = table1_scaled(name, scale=0.002, seed=1)
    return (DeviceGraph.from_host(host, device=dev),
            DeviceGraph.from_host(host, device="cpu"))


def _same_result(got, want):
    """Tensor fields equal, counters equal; ``got`` on the card."""
    assert torch.equal(got.labels.cpu(), want.labels)
    assert got.work.as_ints() == want.work.as_ints()
    if hasattr(want, "parents"):
        assert torch.equal(got.parents.cpu(), want.parents)
    if hasattr(want, "stats"):
        assert {k: int(v) for k, v in got.stats.items()} == \
            {k: int(v) for k, v in want.stats.items()}


@pytest.mark.parametrize("name", STANDINS)
def test_sampled_engines_on_card_match_cpu(dev, name):
    """``sampled_fused`` runs its residue scan on the fused kernel (at
    least one launch, also where the residue is empty), ``sampled`` on
    torch ops; both equal the CPU port in labels, parents, counters and
    stats."""
    from repro_torch.core import sampled
    g, gc = _on_both(name, dev)
    for fused in (False, True):
        cc_ops.KERNEL.launches = 0
        got = sampled.solve_sampled(g, fused=fused)
        torch.cuda.synchronize()
        launches = cc_ops.KERNEL.launches
        _same_result(got, sampled.solve_sampled(gc, fused=fused))
        assert launches >= 1 if fused else launches == 0
    want = connected_components_scipy(gc.edges.numpy(), gc.num_nodes)
    np.testing.assert_array_equal(got.labels.cpu().numpy(), want)


def test_giant_component_ties_on_card_go_to_the_first_label(dev):
    """Two sampled components of equal size: the census argmax takes the
    lower label on the card too."""
    from repro_torch.core import sampled
    edges = np.array([[5, 6], [6, 7], [0, 1], [1, 2], [3, 4]], np.int32)
    for fused in (False, True):
        got = sampled.solve_sampled(edges, 9, fused=fused, device=dev)
        assert (int(got.stats["giant_label"]),
                int(got.stats["giant_size"])) == (0, 3)


@pytest.mark.parametrize("name", ("usa-osm", "kron-logn21"))
def test_forest_and_queries_on_card_match_cpu(dev, name):
    from repro_torch.connectivity import queries
    g, gc = _on_both(name, dev)
    for method in cc.FOREST_METHODS:
        got = cc.solve_forest(g, method=method)
        want = cc.solve_forest(gc, method=method)
        _same_result(got, want)
    labels, labels_c = got.labels, want.labels
    stats = queries.spanning_forest_stats(labels, got.parents)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in queries.spanning_forest_stats(
            labels_c, want.parents).items()}
    rng = np.random.default_rng(5)
    n = gc.num_nodes
    pairs = rng.integers(-n - 3, 2 * n, (4099, 2)).astype(np.int32)
    for fn, args in ((queries.same_component, (pairs,)),
                     (queries.component_size, (pairs[:, 0],)),
                     (queries.component_census, ()),
                     (queries.component_sizes, ()),
                     (queries.count_components, ()),
                     (queries.component_histogram, ())):
        a = fn(labels, *args)
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), fn(labels_c, *args)), fn.__name__
    big = torch.zeros(2**25 - 1, dtype=torch.int32, device=dev)
    hist = queries.component_histogram(big).cpu()
    assert hist[24] == 1 and int(hist.sum()) == 1


@pytest.mark.parametrize("name", STANDINS)
def test_solver_on_card_matches_cpu(dev, name):
    """Plans and solves through the facade on the card equal the CPU
    port's; ``backend="pallas"`` launches K2's snapshot body once per
    hook round of ``adaptive``, and every backend on a CUDA graph stays
    there."""
    from repro_torch.api import Solver, available_backends
    from repro_torch.connectivity.policy import AutotuneCache
    g, gc = _on_both(name, dev)
    s = Solver.open(g, policy_cache=AutotuneCache(None))
    sc = Solver.open(gc, policy_cache=AutotuneCache(None))
    assert s.plan().explain() == sc.plan().explain()
    for backend in available_backends():
        if backend == "labelprop" and name.endswith("osm"):
            continue                # thousands of rounds on a road graph
        if backend == "batched":    # a fleet backend: refused alike
            with pytest.raises(ValueError, match="runs fleets"):
                s.solve(backend=backend)
            continue
        if backend == "distributed":    # needs a mesh session
            with pytest.raises(ValueError, match="needs a mesh"):
                s.solve(backend=backend)
            continue
        hook_ops.KERNEL.launches = 0
        got = s.solve(backend=backend)
        torch.cuda.synchronize()
        _same_result(got, sc.solve(backend=backend))
        assert got.labels.device.type == "cuda", backend
        assert s.last_plan.artifacts == sc.last_plan.artifacts, backend
        if backend == "pallas":
            rounds_ = sc.solve(backend="adaptive").work.hook_rounds
            assert hook_ops.SNAPSHOT.launches == hook_ops.KERNEL.launches \
                == int(rounds_)
    _same_result(s.solve(), sc.solve())
    assert s.num_components() == sc.num_components()
    np.testing.assert_array_equal(s.component_histogram(),
                                  sc.component_histogram())


# ---------------------------------------------------------------------------
# recsys kernels: embedding_bag and segment_reduce
# ---------------------------------------------------------------------------

def _table(rows: int, dim: int, dtype, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn((rows, dim), generator=g, device=dev).to(dtype)


# (vocab, dim, bags, bag): 16-byte vector rows (dim 16, 8), rows that
# take the scalar path (dim 5, 12 in bf16 / dim 6 in f32), the feature
# count as a bag, and a bag count that fills no whole block; bags of 1
# whose count is no multiple of a block's rows (128 at dim 16 in bf16),
# one row alone, and 3M rows (a grid of 23,438 blocks)
EB_CASES = [(1000, 16, 4096, 1), (1000, 16, 777, 4), (300, 8, 256, 26),
            (500, 5, 300, 3), (200, 12, 1000, 1), (64, 6, 129, 8),
            (1000, 16, 4099, 1), (1000, 16, 1, 1), (5000, 16, 3000017, 1),
            (300, 5, 1001, 1)]


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


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("dim", (4, 16))
def test_embedding_bag_kernel_unaligned_table_bag_1(dev, dim, dtype):
    """Bags of 1 on a table view that starts one element into its
    storage (no 16-byte vectors: one element a thread) equal the
    gather."""
    base = _table(301, dim, dtype, dim, dev)
    table = base.view(-1)[1:1 + 300 * dim].view(300, dim)
    idx = _edges(300, 2001, 5, dev).view(-1)[:2001].reshape(2001, 1) \
        .contiguous()
    for combine in ("sum", "mean"):
        got = eb_ops.embedding_bag(table, idx, combine=combine)
        torch.cuda.synchronize()
        assert torch.equal(got, eb_ref.ref_embedding_bag(table, idx,
                                                         combine))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("bag", (2, 4, 9, 26))
def test_embedding_bag_kernel_sums_rows_in_index_order(dev, bag, dtype):
    """Bags of more than one row are the fp32 sum of the rows in index
    order, rounded once (mean: that sum over ``bag``, rounded again), bit
    for bit."""
    table = _table(5000, 16, dtype, bag, dev)
    idx = _edges(5000, 3000 * bag, bag, dev).view(-1)[:3000 * bag] \
        .reshape(3000, bag).contiguous()
    acc = torch.zeros((3000, 16), dtype=torch.float32, device=dev)
    for j in range(bag):
        acc = acc + table[idx[:, j].long()].float()
    want = acc.to(dtype)
    got = eb_ops.embedding_bag(table, idx, combine="sum")
    mean = eb_ops.embedding_bag(table, idx, combine="mean")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a tensor divisor: torch divides by a Python scalar through its
    # reciprocal, which is not the kernel's (or the reference's) division
    want32 = want.float()
    assert torch.equal(mean, (want32 / torch.full_like(want32, bag))
                       .to(dtype))


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
    copy) per call of the sorted body, at the embedding bag's shape, and
    the body's launch counter moves by one. The profiler's device trace
    can come back empty: such a profile is taken again, up to three
    times, and an empty one never passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data = _table(60000, 16, dtype, 7, dev)
    ids = torch.sort(torch.randint(0, 13312, (60000,), device=dev,
                                   generator=torch.Generator(dev).manual_seed(
                                       7))).values.to(torch.int32)
    sr_ops.segment_reduce(data, ids, 13312, indices_are_sorted=True)
    torch.cuda.synchronize()
    for _ in range(3):
        before = (sr_ops.SORTED.launches, sr_ops.ATOMIC.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sr_ops.segment_reduce(data, ids, 13312, indices_are_sorted=True)
            torch.cuda.synchronize()
        assert (sr_ops.SORTED.launches, sr_ops.ATOMIC.launches) == (
            before[0] + 1, before[1])
        ops = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and e.self_device_time_total > 0]
        if ops:
            break
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
                                   combine, indices_are_sorted=True)
        assert sr_ops.KERNEL.launches == sr_ops.SORTED.launches == launches
        want = eb_ref.ref_embedding_bag(model.table, cand[:30].view(10, 3),
                                        combine)
        assert bool(((out.float() - want.float()).abs()
                     <= 2 * fa_ref.ulp_bf16(want)).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("combine", ("sum", "mean"))
def test_embedding_bag_shuffled_bag_ids_on_card_match_plain(dev, combine,
                                                            dtype):
    """Bag ids in no order (rows of a bag not contiguous, some bags
    empty) through ``recsys.embedding_bag`` on the card: the default
    takes segment_reduce's atomic body, and the bags equal the plain
    route's (the same call on the CPU): fp32 within 1e-5 (1 + |ref|),
    two summation orders; bf16 within one ulp for sum (two fp32 sums of
    another order, each rounded once) and three for mean (one ulp of the
    sum over the count is under two ulps of the mean, and the division
    rounds once on each side)."""
    rng = np.random.default_rng(12)
    lengths = rng.integers(0, 9, 3000)
    bag_ids = torch.from_numpy(rng.permutation(np.repeat(
        np.arange(3000), lengths)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 5000, bag_ids.shape[0]).astype(
        np.int32))
    table = _table(5000, 16, dtype, 7, dev)
    sr_ops.KERNEL.launches = 0
    got = recsys.embedding_bag(table, idx.to(dev), bag_ids.to(dev), 3000,
                               combine)
    torch.cuda.synchronize()
    assert sr_ops.KERNEL.launches == sr_ops.ATOMIC.launches == (
        1 if combine == "sum" else 2)
    want = recsys.embedding_bag(table.cpu(), idx, bag_ids, 3000, combine)
    got, want = got.cpu().float(), want.float()
    if dtype == torch.float32:
        assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())
    else:
        ulps = 1 if combine == "sum" else 3
        assert bool(((got - want).abs()
                     <= ulps * fa_ref.ulp_bf16(want)).all())


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


@pytest.mark.parametrize("mod", (gemma2_2b, qwen2_5_32b, minicpm3_4b,
                                 grok_1_314b, phi3_5_moe))
def test_smoke_engine_on_card_matches_port_on_cpu(dev, mod):
    """The smoke-config engine (float32) on the card gives the port's
    CPU tokens, and every prefill launches the kernel once per layer."""
    cfg = mod.make_smoke_config()
    params = T.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    # non-zero norm weights: at the reference's zero init the logits of
    # every model without gemma's 1 + norms are all 0
    g = torch.Generator().manual_seed(5)
    for name, t in T.flatten(params).items():
        if "ln" in name or name.endswith("norm"):
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


@pytest.mark.parametrize("b,s,h,d,dv", [(1, 300, 40, 96, 64),
                                        (2, 129, 8, 96, 64),
                                        (1, 200, 4, 24, 16)])
def test_flash_attention_padded_mla_shape_matches_plain(dev, b, s, h, d, dv):
    """MLA's prefill (q / k head dim 96, v 64; the smoke config's 24 /
    16) through ``layers.multi_head_attention``: zero-padded to 128 (32),
    one launch of the body ``body_of`` names, within the Hopper body's
    p-rounding gates (1 ulp + 1e-5 on the FMA body) of the plain version
    of the padded call; the padded columns come back 0, and that plain
    version equals the unpadded attention in f32."""
    g = torch.Generator(dev).manual_seed(d + s)
    q, k = (torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device=dev).bfloat16()
    dp = min(x for x in fa_ops.HEAD_DIMS if x >= d)
    body = fa_ops.body_of(torch.bfloat16, dp)
    assert body is (fa_ops.WGMMA if dp == 128 else fa_ops.FMA)
    pad = [torch.nn.functional.pad(x, (0, dp - x.shape[-1]))
           for x in (q, k, v)]
    before = body.launches
    pos = torch.arange(s, device=dev)
    got = L.multi_head_attention(q, k, v, q_positions=pos, k_positions=pos,
                                 sm_scale=d ** -0.5)
    assert body.launches == before + 1 and got.shape == (b, s, h, dv)
    full = fa_ops.flash_attention(*pad, sm_scale=d ** -0.5)
    assert bool((full[..., dv:] == 0).all())
    assert torch.equal(full[..., :dv], got)
    kw = dict(sm_scale=d ** -0.5)
    want = fa_ref.ref_flash_attention(*pad, **kw)
    err = (full.float() - want.float()).abs()
    if body is fa_ops.WGMMA:
        tol = fa_ref.p_rounding_bound(*pad, **kw)
        assert float(err.norm()) <= fa_ref.p_rounding_norm_bound(*pad, **kw)
    else:
        tol = fa_ref.ulp_bf16(want) + 1e-5
    assert bool((err <= tol).all()), float((err - tol).max())
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(b * h, s, x.shape[-1])
    plain = [torch.einsum("bqk,bkd->bqd", fa_ref.attention_probs(
        fold(x_q), fold(x_k), sm_scale=d ** -0.5, causal=True),
        fold(x_v).float()) for x_q, x_k, x_v in ((q, k, v), pad)]
    assert float((plain[1][..., :dv] - plain[0]).abs().max()) <= 1e-5


@pytest.mark.parametrize("e,t,chunk", [(4, 38, 16384), (16, 4, 16384),
                                       (8, 300, 128)])
def test_moe_apply_on_card_matches_cpu(dev, e, t, chunk):
    """bf16 ``moe_apply`` (float32 router) on the card against itself on
    the CPU: the routing (experts, ranks, keep) equal, the output within
    the bf16 forward gate (2e-2 of its largest |value|)."""
    cfg = M.MoEConfig(num_experts=e, top_k=2, d_ff_expert=96,
                      dispatch_chunk=chunk)
    params = M.moe_params(64, cfg, torch.bfloat16,
                          generator=torch.Generator().manual_seed(e),
                          device="cpu")
    x = torch.randn((1, t, 64), generator=torch.Generator().manual_seed(t)
                    ).bfloat16()
    outs, routes = [], []
    route = M.route
    for device in ("cpu", dev):
        seen = []
        M.route = lambda *a: seen.append(route(*a)) or seen[-1]
        try:
            out, aux = M.moe_apply({k: w.to(device) for k, w in
                                    params.items()}, x.to(device), cfg)
        finally:
            M.route = route
        outs.append((out.float().cpu(), float(aux)))
        routes.append(seen)
    for a, b in zip(*routes):
        for key in ("gate_idx", "pos", "keep"):
            assert torch.equal(a[key], b[key].cpu()), key
    err = float((outs[1][0] - outs[0][0]).abs().max())
    assert err <= 2e-2 * float(outs[0][0].abs().max()), err
    assert abs(outs[1][1] - outs[0][1]) <= 1e-6


# -- the dynamic engine (DynamicCC behind Solver.insert / delete) -------------

def _dynamic_stream(device, route: str, n: int, edges: np.ndarray):
    """A seeded insert / delete stream through ``Solver`` on ``route``:
    per tick (labels, version, WorkCounters), and the session."""
    from repro_torch.api import Solver
    from repro_torch.connectivity import policy
    rng = np.random.default_rng(1)
    order = np.random.default_rng(0).permutation(edges.shape[0])
    s = Solver.open(num_nodes=n, delete_route=route, device=device,
                    policy_cache=policy.AutotuneCache(None))
    ticks = []
    for part in np.array_split(np.arange(order.shape[0]), 4):
        s.insert(edges[order[part]])
        ticks.append((s.labels.cpu(), s.version, s.work))
        live = edges[order[:part[-1] + 1]]
        for _ in range(3):
            s.delete(live[rng.integers(0, live.shape[0], 40)])
            ticks.append((s.labels.cpu(), s.version, s.work))
    return ticks, s


@pytest.mark.parametrize("route", ("tombstone-delete",
                                   "tombstone-delete-fused",
                                   "tombstone-delete-forest"))
@pytest.mark.parametrize("name", ("usa-osm", "kron-logn21"))
def test_dynamic_stream_on_card_matches_cpu(dev, name, route):
    """The same stream on the card and on the CPU: labels, version and
    all five counters equal after every tick; on the fused route the
    kernel launched at least once, on the forest route its forest body
    (both graphs' π fit the L2)."""
    g = table1_scaled(name, scale=0.002, seed=1)
    edges = np.asarray(g.edges, np.int32)
    cc_ops.KERNEL.launches = 0
    forest = cc_ops.FOREST.launches
    got, s = _dynamic_stream(dev, route, g.num_nodes, edges)
    launches = cc_ops.KERNEL.launches
    forest = cc_ops.FOREST.launches - forest
    want, _ = _dynamic_stream("cpu", route, g.num_nodes, edges)
    for i, ((gl, gv, gw), (wl, wv, ww)) in enumerate(zip(got, want)):
        assert torch.equal(gl, wl), i
        assert (gv, gw) == (wv, ww), i
    if route == "tombstone-delete-fused":
        assert launches >= 1
    if route == "tombstone-delete-forest":
        assert forest >= 1
    survivors = s.graph()
    ref = connected_components_scipy(
        survivors.edges[:survivors.true_edges].cpu().numpy(), g.num_nodes)
    np.testing.assert_array_equal(s.labels.cpu().numpy(), ref)


# -- the forest body: the id-recording scan in one launch ---------------------

def _forest_scan_case(case: str):
    """(pi0, edges, ids, segment size, counts, lift_steps) as numpy /
    host tensors, seeded:
    * ``skeleton``: a Kronecker graph's rows packed into a buffer |V|
      rows long, as the skeleton phase packs the forest: 1,024-row
      segments, the tail ones empty, over a compressed π whose other
      vertices keep their labels;
    * ``chain``: a path in order, so each segment hooks a 1,024-long
      chain (about 11 sweeps a segment), lifted twice;
    * ``ties``: 300 copies of one edge in both orientations among random
      rows of one segment, and 200 of another in a later one, ids
      shuffled: the lowest slot of each tie must win."""
    n, seg = 1 << 15, 1024
    pi = np.arange(n, dtype=np.int32)
    if case == "skeleton":
        g = rmat(15, 8, seed=3)
        rows = np.asarray(g.edges, np.int32)[:20_000]
        keep = np.random.default_rng(4).random(n) < 0.3
        pi[keep] = np.minimum(pi[keep], 7)       # roots 0-7 keep labels
        lift = 0
    elif case == "chain":
        rows = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
        lift = 2
    else:
        rng = np.random.default_rng(5)
        rows = rng.integers(0, n, (4 * seg, 2))
        tie = rng.choice(seg, 300, replace=False)
        rows[tie] = np.where(rng.random((300, 1)) < 0.5, [7, 3], [3, 7])
        tie = 2 * seg + rng.choice(seg, 200, replace=False)
        rows[tie] = [900, 40]
        lift = 0
    rows = rows.astype(np.int32)
    n_true = rows.shape[0]
    cap = n if case == "skeleton" else n_true
    edges = np.zeros((cap, 2), np.int32)
    edges[:n_true] = rows
    ids = np.full(cap, -1, np.int32)
    ids[:n_true] = np.random.default_rng(6).permutation(n_true)
    counts = torch.clamp(n_true - torch.arange(-(-cap // seg)) * seg, 0, seg)
    return pi, edges, ids, seg, counts, lift


def _forest_scan_on(device, pi, edges, ids, seg, counts, lift):
    """``forest_segment_scan_ids`` from empty tables on ``device``: (pi,
    parents, parent_eidx, the five counters as ints)."""
    n = pi.shape[0]
    out = rounds.forest_segment_scan_ids(
        torch.from_numpy(pi).to(device), rounds.empty_forest(n, device),
        rounds.empty_forest_idx(n, device),
        torch.from_numpy(edges).to(device), torch.from_numpy(ids).to(device),
        seg, rounds.WorkCounters.zeros(device), counts, lift_steps=lift)
    return [t.cpu() for t in out[:3]] + [out[3].as_ints()]


def _counter_delta(before: dict) -> dict:
    from repro_torch.obs import trace as obs
    now = obs.tracer().counters
    return {k: now.get(k, 0) - before.get(k, 0)
            for k in ("read.sweep", "read.scan_sweeps")}


@pytest.mark.parametrize("case", ("skeleton", "chain", "ties"))
def test_forest_device_scan_matches_host_loop_and_cpu(dev, monkeypatch,
                                                      case):
    """The one-launch scan against the host loop on the card (gate
    forced off) and the CPU: π, ``parents``, ``parent_eidx`` and all
    five counters bit-equal; the engaged scan launched once, read its
    sweeps once and no sweep flag."""
    from repro_torch.obs import trace as obs
    args = _forest_scan_case(case)
    assert rounds.forest_scan_loop(args[0].shape[0], dev) == "device"
    launches = cc_ops.FOREST.launches
    before = dict(obs.tracer().counters)
    got = _forest_scan_on(dev, *args)
    assert cc_ops.FOREST.launches == launches + 1
    assert _counter_delta(before) == {"read.sweep": 0, "read.scan_sweeps": 1}
    with monkeypatch.context() as m:
        m.setattr(rounds, "forest_scan_fits_l2", lambda *a: False)
        before = dict(obs.tracer().counters)
        host = _forest_scan_on(dev, *args)
        assert _counter_delta(before)["read.sweep"] == \
            host[3]["jump_sweeps"]
    assert cc_ops.FOREST.launches == launches + 1
    cpu = _forest_scan_on("cpu", *args)
    for want in (host, cpu):
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert got[3] == want[3]
    assert (got[1][:, 0] >= 0).sum() > 0
    if case == "chain":
        assert got[3]["jump_sweeps"] > 8 * got[3]["hook_rounds"]
    if case == "ties":
        # the lowest slot of each tie wins row 7 and row 900
        n_true = int(args[4].sum())
        rows, ids = args[1][:n_true], args[2][:n_true]
        for hi, lo in ((7, 3), (900, 40)):
            slot = np.flatnonzero(np.maximum(rows[:, 0], rows[:, 1]) == hi)
            slot = slot[np.minimum(rows[slot, 0], rows[slot, 1]) == lo][0]
            assert got[1][hi].tolist() == rows[slot].tolist()
            assert int(got[2][hi]) == ids[slot]


def test_forest_device_scan_with_fuel_exhausted_matches_plain(dev):
    """Two sweeps a segment cannot flatten a 1,024-long chain: the kernel
    stops mid-segment, carries the unflattened π into the next hook, and
    every segment's count, π and the tables equal the plain version's."""
    pi, edges, ids, seg, counts, lift = _forest_scan_case("chain")
    n = pi.shape[0]
    out = {}
    for d in (dev, "cpu"):
        parents = rounds.empty_forest(n, d)
        eidx = rounds.empty_forest_idx(n, d)
        p, sw = cc_ops.fused_forest_scan(
            torch.from_numpy(pi).to(d), parents, eidx,
            torch.from_numpy(edges).to(d), torch.from_numpy(ids).to(d),
            counts, segment_size=seg, lift_steps=0, fuel=2)
        out[str(d)] = [t.cpu() for t in (p, parents, eidx, sw)]
    got, want = out[str(dev)], out["cpu"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[3] == 2).all()


@pytest.mark.parametrize("name", ("usa-osm", "kron-logn21"))
def test_forest_rebuild_device_scan_matches_host_loop_and_cpu(dev,
                                                              monkeypatch,
                                                              name):
    """``ensure_forest`` over the log's adaptive segments, lifted twice:
    labels, ``parents``, ``parent_eidx`` and the five counters of the
    device loop equal the host loop's and the CPU's; the rebuild span's
    ``loop`` tag names the loop that ran."""
    from repro_torch.core.incremental import DynamicCC
    from repro_torch.obs import trace as obs
    g = table1_scaled(name, scale=0.002, seed=1)
    edges = np.asarray(g.edges, np.int32)

    def rebuilt(device, loop):
        dyn = DynamicCC(g.num_nodes, lift_steps=2, device=device)
        dyn.insert(edges)
        dyn.work
        dyn._forest_valid = False
        obs.enable()
        obs.tracer().reset()
        try:
            dyn.ensure_forest()
            (span,) = [e for e in obs.tracer().log.events()
                       if e["name"] == "dyn.forest.rebuild"]
        finally:
            obs.disable()
        assert span["tags"]["loop"] == loop
        return [t.cpu() for t in (dyn.labels, *dyn.forest)], dyn.work

    launches = cc_ops.FOREST.launches
    got = rebuilt(dev, "device")
    assert cc_ops.FOREST.launches == launches + 1
    with monkeypatch.context() as m:
        m.setattr(rounds, "forest_scan_fits_l2", lambda *a: False)
        host = rebuilt(dev, "host")
    for want in (host, rebuilt("cpu", "host")):
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert got[1] == want[1]


# -- the multi-shard engine and the fleet (A10) ------------------------------

@pytest.mark.parametrize("name", ("usa-osm", "kron-logn21"))
def test_distributed_two_slots_on_card_match_pallas_fused(dev, name):
    """A 2-slot mesh on the card: labels equal ``pallas_fused``'s and the
    oracle's; K1 launches twice a round (once a slot) and K3's fixpoint
    body once a round."""
    from repro_torch.api import Solver
    from repro_torch.core import distributed
    from repro_torch.launch.mesh import make_mesh
    g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1),
                              device=dev)
    mesh = make_mesh(2)
    s = Solver.open(g, mesh=mesh)
    assert s.plan().backend == "distributed"
    res = s.solve()
    sharded = g.shard(mesh)
    fn = distributed.build_distributed_cc(sharded, mesh)
    for k in (cc_ops.KERNEL, mj_ops.ROOTS, mj_ops.SEQUENTIAL):
        k.launches = 0
    labels = fn(sharded)
    torch.cuda.synchronize()
    assert 1 <= fn.last_rounds <= 8
    assert cc_ops.KERNEL.launches == 2 * fn.last_rounds
    assert mj_ops.ROOTS.launches == fn.last_rounds
    assert mj_ops.SEQUENTIAL.launches == 0
    assert torch.equal(labels, res.labels)
    fused = cc.solve_static(g, method="pallas_fused")
    assert res.labels.device.type == "cuda"
    assert torch.equal(res.labels, fused.labels)
    np.testing.assert_array_equal(
        res.labels.cpu().numpy(),
        connected_components_scipy(g.edges.cpu().numpy(), g.num_nodes))


def test_fleet_defaults_to_cuda_devices(dev):
    from repro_torch.fleet import FleetService
    fs = FleetService(rebalance_every=0, shard_threshold=1 << 11)
    assert fs.devices == [torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())]
    assert all(s.device.type == "cuda" for s in fs.shards)
    fs.admit("t", 32)
    fs.admit("whale", 1 << 11, expected_edges=1 << 12)
    fs.submit_insert("t", [[0, 1], [1, 2]])
    fs.submit_insert("whale", [[0, 1], [5, 6]])
    fs.run()
    fs.submit_query("t", "same_component", [[0, 2], [0, 3]])
    fs.submit_query("t", "component_size", [0, 3])
    fs.submit_query("whale", "same_component", [[0, 1], [0, 5]])
    done = {(r.tenant, r.kind): r for r in fs.run()}
    assert all(r.error is None for r in done.values())
    np.testing.assert_array_equal(done["t", "same_component"].result,
                                  [True, False])
    np.testing.assert_array_equal(done["t", "component_size"].result, [3, 1])
    np.testing.assert_array_equal(done["whale", "same_component"].result,
                                  [True, False])


# ---------------------------------------------------------------------------
# training: the two kernels' autograd Functions, the train step, restarts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("bag,combine", [(1, "sum"), (3, "sum"),
                                         (4, "mean")])
def test_embedding_bag_backward_matches_plain(dev, bag, combine, dtype):
    """The lookup's table gradient on the card: K5 forward, then the
    sorted route (stable sort, K5 gather, K4's sorted body) equal bit
    for bit to the plain route on the CPU (fp32 sums of each row's terms
    in their original order on both sides, one rounding), and K4's
    atomic body on the same rows within the sum gates of the kernel
    tests (fp32 order; one bf16 ulp). Half the lookups hit one row."""
    vocab, b = 3000, 4096
    table = _table(vocab, 16, dtype, 5, dev).requires_grad_(True)
    idx = _edges(vocab, b * bag, seed=bag, dev=dev).view(-1)[
        :b * bag].reshape(b, bag).contiguous()
    idx[: b // 2, 0] = 7
    cot = _table(b, 16, dtype, 6, dev)
    eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
    out = ag.embedding_bag(table, idx, combine=combine)
    (got,) = torch.autograd.grad((out.float() * cot.float()).sum(), table)
    again = ag.table_grad(cot, idx, vocab, combine)
    torch.cuda.synchronize()
    assert (eb_ops.KERNEL.launches, sr_ops.SORTED.launches,
            sr_ops.ATOMIC.launches) == (3, 2, 0)
    want = ag.table_grad(cot.cpu(), idx.cpu(), vocab, combine)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    rows = (cot / bag if combine == "mean" else cot).repeat_interleave(
        bag, 0)
    atomic = sr_ops.segment_reduce(rows, idx.reshape(-1), vocab)
    torch.cuda.synchronize()
    err = (atomic.float() - got.float()).abs()
    sum_abs = torch.zeros((vocab, 16), device=dev).index_add_(
        0, idx.reshape(-1).long(), rows.float().abs())
    tol = 2 * b * bag * 2.0 ** -24 * sum_abs
    if dtype == torch.bfloat16:
        tol = tol + fa_ref.ulp_bf16(got)
    assert bool((err <= tol).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("sort", (True, False))
def test_segment_sum_backward_matches_plain(dev, sort, dtype):
    """The segment sum's gradient on the card (a K5 gather, 0 for a
    dropped row) equals the plain gather bit for bit, on either K4 body
    forward."""
    n, segs = 5000, 700
    data = _table(n, 16, dtype, 8, dev).requires_grad_(True)
    ids = torch.randint(-2, segs + 2, (n,), device=dev,
                        generator=torch.Generator(dev).manual_seed(8))
    ids = (torch.sort(ids).values if sort else ids).to(torch.int32)
    cot = _table(segs, 16, dtype, 9, dev)
    before = (eb_ops.KERNEL.launches, sr_ops.SORTED.launches,
              sr_ops.ATOMIC.launches)
    out = ag.segment_reduce(data, ids, segs, indices_are_sorted=sort)
    (got,) = torch.autograd.grad((out.float() * cot.float()).sum(), data)
    torch.cuda.synchronize()
    assert (eb_ops.KERNEL.launches, sr_ops.SORTED.launches,
            sr_ops.ATOMIC.launches) == (before[0] + 1, before[1] + sort,
                                        before[2] + (not sort))
    want = ag.gather_rows(cot.cpu(), ids.cpu(), segs)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def _smoke_train(dtype, device, generator_seed=0):
    cfg = dataclasses.replace(dcn_v2.make_smoke_config(), dtype=dtype)
    model = recsys.init(cfg, generator=torch.Generator().manual_seed(
        generator_seed), device="cpu", requires_grad=True)
    return cfg, copy.deepcopy(model).to(device)


def test_train_step_on_card_matches_the_cpu(dev):
    """Three steps of the ``train_batch`` cell's step on the smoke config
    (f32) from the same weights: the card's route (K5 forward, K4's
    sorted body backward, torch ops elsewhere) against the CPU's plain
    route, within 1e-5 (matmuls sum in other orders)."""
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import named
    cfg, on_card = _smoke_train(torch.float32, dev)
    _, on_cpu = _smoke_train(torch.float32, "cpu")
    cells = {d: steps.build_cell("dcn-v2", "train_batch", device=d)
             for d in (dev, "cpu")}
    states = {d: cells[d].init_state(m)
              for d, m in ((dev, on_card), ("cpu", on_cpu))}
    eb_ops.KERNEL.launches = sr_ops.KERNEL.launches = 0
    for i in range(3):
        batch = recsys_batch(1, i, 64, cfg.n_dense, cfg.table_sizes)
        metrics = {d: cells[d].step(states[d], batch)[1] for d in states}
        for k in ("loss", "grad_norm"):
            assert float(metrics[dev][k]) == pytest.approx(
                float(metrics["cpu"][k]), rel=1e-5)
    torch.cuda.synchronize()
    assert (eb_ops.KERNEL.launches, sr_ops.SORTED.launches) == (6, 3)
    got, want = named(states[dev]["params"]), named(states["cpu"]["params"])
    for n in want:
        torch.testing.assert_close(got[n].detach().cpu(), want[n].detach(),
                                   atol=1e-5, rtol=1e-5)


def test_restart_on_card_replays_bit_for_bit(dev, tmp_path):
    """``run_with_restarts`` on the card (bf16 smoke config, a failure
    at step 4, checkpoints every 3): params, m, v and step bit-equal to
    the uninterrupted run. The route is deterministic: K4's sorted body
    sums in order."""
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.launch import steps
    from repro_torch.train.fault_tolerance import (SimulatedFailure,
                                                   run_with_restarts)
    from repro_torch.train.optimizer import named
    cfg = dataclasses.replace(dcn_v2.make_smoke_config(),
                              dtype=torch.bfloat16)
    cell = steps.build_cell("dcn-v2", "train_batch", device=dev)
    host = [recsys_batch(1, i, 256, cfg.n_dense, cfg.table_sizes)
            for i in range(6)]

    def fresh():
        return cell.init_state(recsys.init(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
            requires_grad=True))

    def run(fail_at, d):
        tripped = {"done": False}

        def step_fn(s, batch):
            if fail_at and int(s["step"]) == fail_at and not tripped["done"]:
                tripped["done"] = True
                raise SimulatedFailure("boom")
            return cell.step(s, batch)
        return run_with_restarts(init_state_fn=fresh, step_fn=step_fn,
                                 stream_fn=lambda start: iter(host[start:]),
                                 total_steps=6, ckpt_dir=str(d),
                                 ckpt_every=3, keep=1)

    clean, faulty = run(0, tmp_path / "a"), run(4, tmp_path / "b")
    assert (clean.restarts, faulty.restarts) == (0, 1)
    a, b = clean.final_state, faulty.final_state
    for part in ("m", "v"):
        for n, t in a["opt"][part].items():
            assert torch.equal(t, b["opt"][part][n]), (part, n)
    pb = named(b["params"])
    for n, t in named(a["params"]).items():
        assert torch.equal(t, pb[n]), n
    assert int(a["step"]) == int(b["step"]) == 6


# --------------------------------------------------------------------------
# LM training: the flash kernel's autograd wrapper and the train cell
# --------------------------------------------------------------------------

def _blocked_grads(q, k, v, cot, dp: int, **kw):
    """q, k, v's gradients through ``layers.attention_blocked`` (what the
    wrapper's backward differentiates), positions 0.. on both sides,
    with the head dims zero-padded to ``dp`` as the route pads them."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    pos = torch.arange(q.shape[1], device=q.device, dtype=torch.int32)
    pad = [torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
           for t in (q, k, v)]
    out = L.attention_blocked(*pad, q_positions=pos, k_positions=pos,
                              **kw)[..., :v.shape[-1]]
    return torch.autograd.grad(out, (q, k, v), cot)


@pytest.mark.parametrize("hq,hkv,d,dv,window,cap", [
    (8, 4, 256, 256, 4096, 50.0),     # gemma2-2b's local layer
    (8, 4, 256, 256, 0, 50.0),        # its global layer
    (8, 4, 256, 256, 1024, 50.0),     # a window that cuts the keys
    (40, 40, 96, 64, 0, 0.0)])        # minicpm3-4b's MLA, padded to 128
def test_flash_autograd_on_card_is_k6_then_the_blocked_gradient(
        dev, hq, hkv, d, dv, window, cap):
    """``multi_head_attention`` with grad at a training layer's shape
    ([1, 4096, ...] bf16): one launch of the Hopper body forward, within
    its p-rounding gates of the plain version; the q, k, v gradients
    bit-equal to ``torch.autograd.grad`` of ``attention_blocked`` on the
    same inputs (MLA's through its zero padding)."""
    g = torch.Generator(dev).manual_seed(d + window)
    s = 4096
    q = torch.randn((1, s, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((1, s, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((1, s, hkv, dv), generator=g, device=dev).bfloat16()
    cot = torch.randn((1, s, hq, dv), generator=g, device=dev).bfloat16()
    scale = d ** -0.5
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    pos = torch.arange(s, device=dev, dtype=torch.int32)
    before = fa_ops.WGMMA.launches, fa_ops.FMA.launches
    out = L.multi_head_attention(qg, kg, vg, q_positions=pos,
                                 k_positions=pos, window=window,
                                 attn_softcap=cap, sm_scale=scale)
    torch.cuda.synchronize()
    assert (fa_ops.WGMMA.launches, fa_ops.FMA.launches) == (
        before[0] + 1, before[1])
    got = torch.autograd.grad(out, (qg, kg, vg), cot)
    assert (fa_ops.WGMMA.launches, fa_ops.FMA.launches) == (
        before[0] + 1, before[1])
    dp = 128 if d == 96 else d
    want = _blocked_grads(q, k, v, cot, dp, window=window, attn_softcap=cap,
                          scale=scale)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), f"d{name}"
    pad = [torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
           for t in (q, k, v)]
    kw = dict(sm_scale=scale, window=window, softcap=cap)
    ref = fa_ref.ref_flash_attention(*pad, **kw)[..., :dv]
    err = (out.detach().float() - ref.float()).abs()
    tol = fa_ref.p_rounding_bound(*pad, **kw)[..., :dv]
    assert bool((err <= tol).all()), float((err / tol).max())
    assert float(err.norm()) <= fa_ref.p_rounding_norm_bound(*pad, **kw)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _smoke_lm_state(arch_mod, dev, remat: bool):
    """(config, the train_4k cell built for the smoke config in f32 with
    ``remat``, a state over seeded weights with non-zero norms)."""
    from repro_torch.launch import steps
    cfg = dataclasses.replace(arch_mod.make_smoke_config(), remat=remat)
    params = T.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    g = torch.Generator().manual_seed(5)
    for name, t in T.flatten(params).items():
        if "ln" in name or name.endswith("norm"):
            t.normal_(0.0, 0.3, generator=g)
    params = _to(params, dev)
    for t in T.flatten(params).values():
        t.requires_grad_(True)
    real = arch_mod.make_config
    arch_mod.make_config = lambda: cfg
    try:
        cell = steps.build_cell(arch_mod.ARCH_ID, "train_4k", device=dev)
    finally:
        arch_mod.make_config = real
    return cfg, cell, cell.init_state(params)


@pytest.mark.parametrize("mod", (gemma2_2b, minicpm3_4b, phi3_5_moe))
def test_lm_train_steps_on_card_fall_and_launch_k6(dev, mod):
    """Four steps of the ``train_4k`` cell's step (smoke config, f32,
    remat on, 4 microbatches) on one repeated batch: every loss finite,
    the last below the first, and the kernel launched twice per layer
    and microbatch (the forward and the checkpoint's recompute), on the
    body ``body_of`` names (FMA: f32)."""
    from repro_torch.data.pipeline import lm_batch
    cfg, cell, state = _smoke_lm_state(mod, dev, remat=True)
    batch = lm_batch(0, 0, 8, 64, cfg.vocab)
    losses = []
    fa_ops.KERNEL.launches = 0
    for _ in range(4):
        state, m = cell.step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert (fa_ops.FMA.launches, fa_ops.WGMMA.launches) == (
        4 * 4 * 2 * cfg.n_layers, 0)


def test_lm_train_step_on_card_matches_the_cpu(dev):
    """One step of gemma2-2b's smoke train cell (f32): the card's route
    (the kernel's forward) against the CPU's (its plain version), loss
    and grad norm within 1e-5 and every parameter within 1e-5 (fp32
    sums in other orders), and remat off gives the card's loss."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.train.optimizer import named
    batch = lm_batch(0, 0, 8, 64, 128)
    out = {}
    for d, remat in ((dev, True), ("cpu", True), (dev, False)):
        _, cell, state = _smoke_lm_state(gemma2_2b, torch.device(d), remat)
        state, m = cell.step(state, batch)
        out[(str(d), remat)] = (m, named(state["params"]))
    card, cpu = out[(str(dev), True)], out[("cpu", True)]
    for k in ("loss", "grad_norm"):
        assert float(card[0][k]) == pytest.approx(float(cpu[0][k]), rel=1e-5)
    assert float(out[(str(dev), False)][0]["loss"]) == pytest.approx(
        float(card[0]["loss"]), rel=1e-6)
    for n, t in cpu[1].items():
        torch.testing.assert_close(card[1][n].detach().cpu(), t.detach(),
                                   atol=1e-5, rtol=1e-5)


def test_lm_launcher_on_card_recovers(dev, capsys):
    """``launch.train --arch gemma2-2b --steps 30 --fail-at 15`` on the
    card (no ``--device``): returns 0 after one restart."""
    from repro_torch.launch import train as launch_train
    rc = launch_train.main(["--arch", "gemma2-2b", "--steps", "30",
                            "--fail-at", "15"])
    out = capsys.readouterr().out
    assert rc == 0 and "on cuda" in out and " 1 restarts" in out, out


# --------------------------------------------------------------------------
# GNN training: message passing on K4, its gradient on K5
# --------------------------------------------------------------------------

# (K4, K5) launches of one train pass (forward and backward) of each
# smoke config on the launcher's smoke batch: GraphSAGE 2 layers x (sum,
# degree), one backward gather (layer 0's input needs none); GIN 2
# layers + the graph pooling, the first layer's sum without a backward;
# GatedGCN 3 layers x 2 sums, run again by remat, each with a backward;
# NequIP 2 layers x 11 paths + the energy, twice more under the layer's
# and the chunk's remat, and no backward for the last layer's 8 sums
# into l > 0
GNN_LAUNCHES = {"graphsage-reddit": (4, 1), "gin-tu": (3, 2),
                "gatedgcn": (12, 6), "nequip": (67, 15)}


def _plain_message_passing(monkeypatch):
    monkeypatch.setattr(sr_ops, "segment_reduce", lambda d, i, n, *, op="sum",
                        indices_are_sorted=False:
                        sr_ref.ref_segment_reduce(d, i, n, op))
    monkeypatch.setattr(eb_ops, "embedding_bag", lambda t, i, *,
                        combine="sum": eb_ref.ref_embedding_bag(t, i, combine))


@pytest.mark.parametrize("arch", tuple(GNN_LAUNCHES))
def test_gnn_train_step_on_card_matches_the_plain_route(dev, arch,
                                                        monkeypatch):
    """Each GNN's smoke config (f32) on the launcher's batch and on three
    edge permutations of it (the same sums in other fp32 orders, which is
    all K4's atomics change): passes through the kernels (K4's atomic
    body for every message sum, K5 for each of their gradients, counted)
    and through the all-plain route on the card. The kernel runs' nearest
    gap to a plain run, on the loss, the whole gradient and the worst
    leaf, within 4x the widest gap between two plain runs (the loss's
    gate at least 4 fp32 ulps of it): a ReLU input within rounding of 0
    flips a gradient term on some runs only. Then one step of the train
    cell: finite, launching one pass's counts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.train import _gnn_batch
    from repro_torch.models.gnn import model_of
    from repro_torch.train.optimizer import named
    mod, M = get_arch(arch), model_of(arch)
    cfg = mod.make_smoke_config()
    host = _gnn_batch(arch, cfg, 0, 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    params = M.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev, requires_grad=True)
    leaves = named(params)

    def run(b):
        loss = M.loss_fn(params, b, cfg)
        return float(loss), torch.autograd.grad(loss, list(leaves.values()))

    variants = [batch]
    for seed in (1, 2, 3):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            host["src"].shape[0])).to(dev)
        variants.append({**batch, **{k: batch[k][perm] for k in (
            "src", "dst", "edge_attr") if k in batch}})
    sr_ops.KERNEL.launches = eb_ops.KERNEL.launches = 0
    kernel = [run(b) for b in variants]
    torch.cuda.synchronize()
    assert (sr_ops.ATOMIC.launches, eb_ops.KERNEL.launches) == tuple(
        4 * n for n in GNN_LAUNCHES[arch]) and sr_ops.SORTED.launches == 0
    with monkeypatch.context() as m:
        _plain_message_passing(m)
        plain = [run(b) for b in variants]
    torch.cuda.synchronize()

    def gaps(got, ref):
        diff = [float((a - b).norm()) for a, b in zip(got[1], ref[1])]
        whole = float(np.sqrt(sum(x * x for x in diff))) / float(
            np.sqrt(sum(float(b.norm()) ** 2 for b in ref[1])))
        worst = max(x / float(b.norm()) for x, b in zip(diff, ref[1])
                    if float(b.norm()))
        return abs(got[0] - ref[0]), whole, worst
    within = [gaps(a, b) for i, a in enumerate(plain) for b in plain[i + 1:]]
    gate = [4 * max(c) for c in zip(*within)]
    gate[0] = max(gate[0], 4 * float(np.spacing(np.float32(abs(plain[0][0])))))
    nearest = [min(c) for c in zip(*(gaps(k, p) for k in kernel
                                     for p in plain))]
    assert all(g <= t for g, t in zip(nearest, gate)), (nearest, gate)
    real = mod.make_config
    mod.make_config = lambda shape=None: cfg
    try:
        cell = steps.build_cell(arch, "molecule", device=dev)
    finally:
        mod.make_config = real
    state = cell.init_state(params)
    sr_ops.KERNEL.launches = eb_ops.KERNEL.launches = 0
    state, metrics = cell.step(state, host)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert (sr_ops.ATOMIC.launches, eb_ops.KERNEL.launches) == \
        GNN_LAUNCHES[arch]


# --------------------------------------------------------------------------
# NequIP's sharded step and compressed_psum over slots of the card
# --------------------------------------------------------------------------

def test_compressed_psum_on_card_equals_cpu(dev):
    """Four slots of the card against the same call on the CPU: means,
    new residuals, payloads and scales bit-equal (every op correctly
    rounded; the scale divides by a tensor, since CUDA divides by a
    Python scalar through its rounded reciprocal)."""
    from repro_torch.train.compression import (compressed_psum,
                                               shared_payloads)
    rng = np.random.default_rng(27)
    host = [{n: torch.from_numpy((rng.standard_normal(s) * 10.0 ** rng
                                  .integers(-3, 3)).astype(np.float32))
             for n, s in (("a", (1000,)), ("b", (64, 33)), ("c", (7,)))}
            for _ in range(4)]
    res = [{n: torch.zeros_like(g) for n, g in h.items()} for h in host]

    def call(grads, residual):
        return compressed_psum(grads, residual) + shared_payloads(
            grads, residual)[:2]
    on_card = call([{n: g.to(dev) for n, g in h.items()} for h in host],
                   [{n: r.to(dev) for n, r in h.items()} for h in res])
    on_cpu = call(host, res)
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for n in x:
                assert torch.equal(x[n].cpu(), y[n]), n


def test_nequip_sharded_step_on_card(dev, monkeypatch):
    """The smoke config's train step over 2 slots of the card against
    the one-slot step: each slot's edge chunks and partial energy on K4
    and their gradients on K5 (twice the one-slot launches), the loss
    equal to 1e-6 and the gradient within 1e-5 of the leaf's largest."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _gnn_batch
    from repro_torch.models.gnn import nequip
    mod = get_arch("nequip")
    cfg = mod.make_smoke_config()
    monkeypatch.setattr(mod, "make_config", lambda shape=None: cfg)
    host = _gnn_batch("nequip", cfg, 0, 0)
    params = nequip.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev, requires_grad=True)
    out = {}
    for k in (1, 2):
        cell = steps.build_cell("nequip", "molecule", mesh=make_mesh(k))
        sr_ops.KERNEL.launches = eb_ops.KERNEL.launches = 0
        out[k] = cell.step.loss_and_grads(params, host)
        torch.cuda.synchronize()
        assert (sr_ops.ATOMIC.launches, eb_ops.KERNEL.launches) == tuple(
            k * n for n in GNN_LAUNCHES["nequip"])
    assert float(out[2][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for n, g in out[2][1].items():
        want = out[1][1][n]
        assert float((g - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), n
