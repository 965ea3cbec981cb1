"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where ``torch.cuda.is_available()``
is false (the kernels have no CPU mode). Run them on a machine with an
NVIDIA H100 (``sm_90a``) and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer work: every comparison is exact (tolerance 0). This file imports
no JAX, so it runs where only PyTorch is installed.
"""
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
from repro_torch.kernels.multi_jump import ops as mj_ops, ref as mj_ref

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
