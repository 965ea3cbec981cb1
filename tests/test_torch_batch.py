"""repro_torch's batched engine against repro.core.batch: per graph, the
labels AND all five WorkCounters of ``Solver.solve_batch(...,
device="cpu")`` equal ``repro.api.Solver.solve_batch`` exactly, on the
reference benchmark's three fleets (``benchmarks/run.py``, ``batched``),
a seeded mixed fleet, and the edge cases (an empty graph, |V| = 1, sizes
either side of a power of two, DeviceGraph inputs, ``num_segments=``,
``lift_steps`` 0 and 2); the batched scan's plain version against the
per-graph plain scan; the int32 guard; ``DeviceGraph.concat`` against
the reference's. Integer work: the tolerance is 0."""
import numpy as np
import pytest
import torch

import repro
from repro.graphs import device as jdev
import repro_torch
from repro_torch.core import batch as tbatch
from repro_torch.graphs import device as tdev
from repro_torch.graphs.generators import (chain, disjoint_cliques,
                                           grid_road, rmat)
from repro_torch.kernels.cc_fused import ops as cc_ops, ref as cc_ref

FLEETS = {
    "molecules-64": lambda: [rmat(5, 3, seed=s) for s in range(64)],
    "mixed-48": lambda: (
        [chain(40 + s) for s in range(16)]
        + [disjoint_cliques(3, 4 + s % 3, seed=s) for s in range(16)]
        + [grid_road(8, seed=s) for s in range(16)]),
    "medium-16": lambda: [rmat(8, 8, seed=s) for s in range(16)],
}


def _seeded_fleet(seed: int = 7, count: int = 24) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(1, 90))
        e = int(rng.integers(0, 3 * n + 1))
        out.append((rng.integers(0, n, (e, 2)).astype(np.int32), n))
    return out


def _edge_fleet() -> list:
    """An empty graph, |V| = 1 (with and without its self loop), and
    |V|, |E| on either side of a power of two."""
    rng = np.random.default_rng(3)
    out = [(np.zeros((0, 2), np.int32), 5), (np.zeros((0, 2), np.int32), 1),
           (np.zeros((1, 2), np.int32), 1)]
    for n in (31, 32, 33):
        for e in (15, 16, 17):
            out.append((rng.integers(0, n, (e, 2)).astype(np.int32), n))
    return out


def _pairs(graphs) -> list:
    return [(np.asarray(g.edges), g.num_nodes) if hasattr(g, "num_nodes")
            else g for g in graphs]


def _ints(w) -> list:
    return [int(x) for x in w]


def _assert_equal(got, want) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels),
                                      err_msg=f"graph {i}")
        assert _ints(a.work) == _ints(b.work), i


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_benchmark_fleets_match_reference(name):
    graphs = FLEETS[name]()
    got = repro_torch.Solver.solve_batch(graphs, device="cpu")
    want = repro.Solver.solve_batch(_pairs(graphs))
    _assert_equal(got, want)
    for g, r in zip(graphs, got):
        solo = repro_torch.solve(g.edges, g.num_nodes, method="adaptive",
                                 device="cpu")
        assert torch.equal(r.labels, solo.labels)
    if name == "medium-16":
        # the cleanup rounds ran for some graph (hook_rounds past S)
        s = tbatch.plan_segmentation(*tbatch.bucket_shape(
            256, 2048)[::-1]).num_segments
        assert max(int(r.work.hook_rounds) for r in got) > s


def test_seeded_mixed_fleet_matches_reference():
    graphs = _seeded_fleet()
    _assert_equal(repro_torch.Solver.solve_batch(graphs, device="cpu"),
                  repro.Solver.solve_batch(graphs))


@pytest.mark.parametrize("num_segments,lift_steps",
                         [(None, 2), (3, 2), (None, 0), (1, 0)])
def test_edge_cases_match_reference(num_segments, lift_steps):
    graphs = _edge_fleet()
    got = repro_torch.Solver.solve_batch(
        graphs, num_segments=num_segments, lift_steps=lift_steps,
        device="cpu")
    want = repro.Solver.solve_batch(graphs, num_segments=num_segments,
                                    lift_steps=lift_steps)
    _assert_equal(got, want)
    assert [r.labels.shape[0] for r in got] == [n for _, n in graphs]


def test_device_graph_inputs_match_reference():
    """DeviceGraph fleets bucket on their STORED rows (a pow2-padded
    graph lands in its padded bucket) and bill their true counts."""
    fleet = _seeded_fleet(seed=11, count=10)
    tg = [tdev.DeviceGraph.from_edges(e, n, device="cpu") for e, n in fleet]
    jg = [jdev.DeviceGraph.from_edges(e, n) for e, n in fleet]
    tg[1], jg[1] = tg[1].pad_pow2(), jg[1].pad_pow2()
    tg[2], jg[2] = tg[2].pad_rows(40), jg[2].pad_rows(40)
    got = repro_torch.Solver.solve_batch(tg)
    _assert_equal(got, repro.Solver.solve_batch(jg))
    assert all(r.labels.device.type == "cpu" for r in got)
    with pytest.raises(ValueError, match="lives on"):
        repro_torch.Solver.solve_batch(tg, device="meta")


def test_mixed_host_and_device_inputs_match_reference():
    """A fleet that is not all DeviceGraphs takes the host path, a
    DeviceGraph's stored rows counted as its edges (as the reference
    does)."""
    fleet = _seeded_fleet(seed=5, count=6)
    tg = list(fleet)
    jg = list(fleet)
    tg[0] = tdev.DeviceGraph.from_edges(fleet[0][0], fleet[0][1],
                                        device="cpu").pad_pow2()
    jg[0] = jdev.DeviceGraph.from_edges(fleet[0][0], fleet[0][1]).pad_pow2()
    _assert_equal(repro_torch.Solver.solve_batch(tg, device="cpu"),
                  repro.Solver.solve_batch(jg))


def test_edge_log_view_is_refused():
    log = tdev.EdgeLog(8, device="cpu")
    log.append(tdev.DeviceGraph.from_edges([[0, 1]], 8, device="cpu"))
    with pytest.raises(ValueError, match="static true edge counts"):
        repro_torch.Solver.solve_batch([log.view()])


def test_empty_fleet_and_results_in_input_order():
    assert repro_torch.Solver.solve_batch([], device="cpu") == []
    graphs = [(np.asarray([[0, 1]], np.int32), 300),
              (np.asarray([[1, 2]], np.int32), 3)]
    out = repro_torch.Solver.solve_batch(graphs, device="cpu")
    assert [r.labels.shape[0] for r in out] == [300, 3]
    np.testing.assert_array_equal(out[1].labels.numpy(), [0, 1, 1])


@pytest.mark.parametrize("batch,v_pad,seg,segments,lift_steps",
                         [(1, 8, 8, 1, 2), (5, 8, 3, 4, 2),
                          (3, 64, 20, 3, 0), (4, 16, 40, 1, 1)])
def test_ref_segment_scan_batched_is_per_graph(batch, v_pad, seg, segments,
                                               lift_steps):
    rng = np.random.default_rng(batch * v_pad + seg)
    segs = torch.from_numpy(rng.integers(
        0, v_pad, (batch, segments, seg, 2)).astype(np.int32))
    counts = torch.from_numpy(rng.integers(
        0, seg + 1, (batch, segments)).astype(np.int32))
    pi = torch.from_numpy(np.minimum(
        np.arange(v_pad), rng.integers(0, v_pad, (batch, v_pad)))
        .astype(np.int32))
    got_pi, got_sw = cc_ref.ref_segment_scan_batched(
        pi, segs, counts, lift_steps=lift_steps)
    wrapped = cc_ops.fused_segment_scan_batched(pi, segs, counts,
                                                lift_steps=lift_steps)
    assert torch.equal(wrapped[0], got_pi) and torch.equal(wrapped[1], got_sw)
    assert got_sw.shape == (batch, segments)
    for b in range(batch):
        want_pi, want_sw = cc_ref.ref_segment_scan(
            pi[b], segs[b], counts[b], lift_steps=lift_steps)
        assert torch.equal(got_pi[b], want_pi)
        assert torch.equal(got_sw[b], want_sw)


@pytest.mark.parametrize("log2_vp", range(3, 21))
def test_batched_body_by_shape(log2_vp):
    """A CUDA bucket takes the block body (one graph a block, its two pi
    buffers in shared memory) up to V_pad 16,384, the grid body above."""
    v_pad = 2 ** log2_vp
    assert cc_ops.BLOCK_MAX_V_PAD == 16384
    assert cc_ops.batched_body(v_pad) == ("block" if v_pad <= 16384
                                          else "grid")


def _sweep_bucket(v_pad: int, e_pad: int, seed: int):
    """One bucket's inputs (int32 edges [4, e_pad, 2], true edge and node
    counts): a path in random edge order (many sweeps and cleanup
    rounds), a star (few), random edges, and a graph with no true edge
    (a count of 0 in every segment, as an inactive graph has in a
    cleanup round)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(v_pad)
    path = np.stack([perm[:e_pad], perm[1:e_pad + 1]], 1)[
        rng.permutation(e_pad)]
    star = np.stack([np.full(e_pad, perm[0]), perm[1:e_pad + 1]], 1)
    rand = rng.integers(0, v_pad, (e_pad // 2, 2))
    parts = [path, star, rand, np.zeros((0, 2), np.int64)]
    edges = np.zeros((4, e_pad, 2), np.int32)
    for b, p in enumerate(parts):
        edges[b, :len(p)] = p
    true_edges = np.array([len(p) for p in parts], np.int32)
    true_nodes = np.array([v_pad, v_pad - 5, v_pad // 2 + 1, v_pad],
                          np.int32)
    return edges, true_edges, true_nodes


@pytest.mark.parametrize("v_pad", [cc_ops.BLOCK_MAX_V_PAD,
                                   2 * cc_ops.BLOCK_MAX_V_PAD])
def test_solve_bucket_matches_reference_either_side_of_the_block_limit(
        v_pad):
    """``solve_bucket`` equals the reference's bucket program (labels and
    all five counters per graph) at the V_pad of each batched body, on
    graphs that converge after different sweep counts, with cleanup
    rounds in which the converged graphs scan with a count of 0."""
    import jax.numpy as jnp
    from repro.core import batch as jbatch
    edges, true_edges, true_nodes = _sweep_bucket(v_pad, 2048, v_pad)
    labels, work = tbatch.solve_bucket(
        torch.from_numpy(edges), torch.from_numpy(true_edges),
        torch.from_numpy(true_nodes), v_pad, num_segments=4)
    want = jbatch._cc_batched_jit(
        jnp.asarray(edges), jnp.asarray(true_edges), jnp.asarray(true_nodes),
        num_nodes=v_pad, num_segments=4, lift_steps=2)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want.labels))
    for got_c, want_c in zip(work, want.work):
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    hook_rounds, sweeps = work[3].tolist(), work[2].tolist()
    assert max(hook_rounds) > 4 and min(hook_rounds) == 4
    assert len(set(sweeps)) >= 3


def test_int32_guard_raises():
    """B * V_pad and B * seg must stay below 2^31: the wrapper refuses a
    bucket past it (shape-only views, nothing allocated), as does the
    engine before it allocates a bucket."""
    one = torch.zeros((1, 1), dtype=torch.int32)
    segs = torch.zeros((1, 1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="B \\* V_pad"):
        cc_ops.fused_segment_scan_batched(
            one.expand(2**16, 2**15), segs.expand(2**16, 1, 1, 2),
            one.expand(2**16, 1))
    with pytest.raises(ValueError, match="B \\* seg"):
        cc_ops.fused_segment_scan_batched(
            one.expand(2**16, 8), segs.expand(2**16, 1, 2**15, 2),
            one.expand(2**16, 1))
    with pytest.raises(ValueError, match="power of two"):
        cc_ops.fused_segment_scan_batched(
            torch.zeros((2, 12), dtype=torch.int32),
            torch.zeros((2, 1, 4, 2), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="B \\* V_pad"):
        tbatch.solve_bucket(
            torch.zeros((1, 1, 2), dtype=torch.int32).expand(2**16, 8, 2),
            one[0].expand(2**16), one[0].expand(2**16), 2**15)
    # the scan's segments fit (B * seg = 2^29), the cleanup's one segment
    # over all 2^15 padded slots does not: refused before the scan runs
    with pytest.raises(ValueError, match="B \\* seg"):
        tbatch.solve_bucket(
            torch.zeros((1, 1, 2), dtype=torch.int32).expand(2**16, 2**15, 2),
            one[0].expand(2**16), one[0].expand(2**16), 8, num_segments=4)


def test_batched_backend_capabilities_match_reference():
    got = repro_torch.capability_matrix()["batched"]
    assert got == repro.capability_matrix()["batched"]
    plan_t = repro_torch.get_backend("batched")
    assert plan_t.capabilities.batched


@pytest.mark.parametrize("case", ["plain", "padded", "skew", "single"])
def test_concat_matches_reference(case):
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 20, (k, 2)).astype(np.int32)
             for k in (3, 9, 5)]
    tg = [tdev.DeviceGraph.from_edges(p, 20, device="cpu") for p in parts]
    jg = [jdev.DeviceGraph.from_edges(p, 20) for p in parts]
    if case == "padded":
        tg = [g.pad_pow2() for g in tg]
        jg = [g.pad_pow2() for g in jg]
    if case == "skew":
        # parts that arrived as tensors carry no skew: max of the known
        tg[0] = tdev.DeviceGraph.from_edges(torch.from_numpy(parts[0]), 20)
        jg[0] = jdev.DeviceGraph.from_edges(jdev.jnp.asarray(parts[0]), 20)
    if case == "single":
        tg, jg = tg[:1], jg[:1]
    got = tdev.DeviceGraph.concat(tg, name="c")
    want = jdev.DeviceGraph.concat(jg, name="c")
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    assert got.true_edges == want.true_edges_static
    assert got.plan == want.plan or vars(got.plan) == vars(want.plan)
    assert got.degree_skew == want.degree_skew
    assert got.name == want.name


def test_concat_refusals_match_reference():
    a = tdev.DeviceGraph.from_edges([[0, 1]], 4, device="cpu")
    b = tdev.DeviceGraph.from_edges([[0, 1]], 5, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tdev.DeviceGraph.concat([])
    with pytest.raises(ValueError, match="identical num_nodes"):
        tdev.DeviceGraph.concat([a, b])
    log = tdev.EdgeLog(4, device="cpu")
    log.append(a)
    with pytest.raises(ValueError, match="static true_edges"):
        tdev.DeviceGraph.concat([a, log.view()])
    none = [tdev.DeviceGraph.from_edges(torch.tensor([[0, 1]]), 4)
            for _ in range(2)]
    assert tdev.DeviceGraph.concat(none).degree_skew is None
