"""repro_torch's static solves against repro.core.cc over the named
corpus: canonical labels and all five WorkCounters field-equal for every
ported method, ``solve_pallas`` labels, ``solve_hostloop`` labels and
stats; the Table I stand-ins at scale 0.002 reproduce the reference's
counters. Integer work throughout: the tolerance is 0."""
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.core import cc as jcc
from repro.graphs.device import DeviceGraph as JDeviceGraph
from repro_torch.core import cc as tcc
from repro_torch.core import rounds as tr
from repro_torch.core.unionfind import (connected_components_oracle,
                                        connected_components_scipy)
from repro_torch.graphs.device import DeviceGraph
from repro_torch.graphs.generators import table1_scaled
from repro_torch.kernels.cc_fused.ops import fused_segment_scan
from repro_torch.kernels.hook import ops as hook_ops
from repro_torch.kernels.multi_jump import ops as mj_ops

CASES = corpus()
IDS = [c[0] for c in CASES]
STATIC_METHODS = ("soman", "multijump", "atomic_hook", "adaptive",
                  "labelprop", "pallas_fused")


def _work(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("method", STATIC_METHODS)
def test_solve_static_matches_reference(method, name, n, edges):
    want = jcc.solve_static(edges, n, method)
    got = tcc.solve_static(edges, n, method, device="cpu")
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert got.work.as_ints() == _work(want.work)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_solve_pallas_matches_reference(name, n, edges):
    got = tcc.solve_pallas(edges, n, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcc.solve_pallas(edges, n)))
    np.testing.assert_array_equal(got.numpy(),
                                  connected_components_oracle(edges, n))


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_solve_pallas_pi_after_every_round_equals_adaptive(monkeypatch, name,
                                                           n, edges):
    """``solve_pallas`` hooks each segment and cleanup round from one π
    snapshot, so π after every compress (each segment, then each cleanup
    round) equals the torch-ops ``adaptive``'s, and it makes one hook
    call per ``hook_rounds`` of ``adaptive``."""
    seen = {"pallas": [], "adaptive": [], "hooks": 0}
    real_full, real_compress = mj_ops.full_compress, tr.compress
    real_hook = hook_ops.hook_edges_snapshot

    def full_compress(pi, **kw):
        out = real_full(pi, **kw)
        seen["pallas"].append(out.clone())
        return out

    def compress(pi, work, **kw):
        out = real_compress(pi, work, **kw)
        seen["adaptive"].append(out[0].clone())
        return out

    def hook(pi, edges, **kw):
        seen["hooks"] += 1
        return real_hook(pi, edges, **kw)

    monkeypatch.setattr(mj_ops, "full_compress", full_compress)
    monkeypatch.setattr(tr, "compress", compress)
    monkeypatch.setattr(hook_ops, "hook_edges_snapshot", hook)
    labels = tcc.solve_pallas(edges, n, device="cpu")
    adaptive = tcc.solve_static(edges, n, "adaptive", device="cpu")
    rounds = adaptive.work.as_ints()["hook_rounds"]
    assert seen["hooks"] == len(seen["pallas"]) == rounds
    assert len(seen["adaptive"]) == rounds
    for got, want in zip(seen["pallas"], seen["adaptive"]):
        assert torch.equal(got, want)
    assert torch.equal(labels, adaptive.labels)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("method", ("soman", "multijump"))
def test_solve_hostloop_matches_reference(method, name, n, edges):
    want_labels, want_stats = jcc.solve_hostloop(edges, n, method)
    got_labels, got_stats = tcc.solve_hostloop(edges, n, method,
                                               device="cpu")
    np.testing.assert_array_equal(got_labels, np.asarray(want_labels))
    assert got_stats == want_stats


@pytest.mark.parametrize("method", ("adaptive", "pallas_fused", "soman"))
def test_padded_graph_matches_reference(method):
    """A pow2-padded graph: billing runs on the true count."""
    _, n, edges = CASES[IDS.index("er-mid")]
    jg = JDeviceGraph.from_edges(edges, n).pad_pow2(min_rows=128)
    tg = DeviceGraph.from_reference(np.asarray(jg.edges), jg.num_nodes,
                                    jg.true_edges_static,
                                    jg.plan.num_segments, device="cpu")
    want = jcc.solve_static(jg, method=method)
    got = tcc.solve_static(tg, method=method)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.work.as_ints() == _work(want.work)


# Table I stand-ins, table1_scaled(name, scale=0.002, seed=1): adaptive
# WorkCounters and the summed per-segment sweeps of the fused scan, as
# the reference gives them (hardware-independent).
STANDINS = {
    "usa-osm": ((47961, 62909, 3),
                dict(hook_ops=566181, jump_ops=1390869, jump_sweeps=29,
                     hook_rounds=5, sync_rounds=1), 20),
    "euro-osm-karls": ((346921, 456990, 3),
                       dict(hook_ops=4112910, jump_ops=11448393,
                            jump_sweeps=33, hook_rounds=5, sync_rounds=1),
                       22),
    "soc-live-journal": ((8192, 57344, 14),
                         dict(hook_ops=344064, jump_ops=270336,
                              jump_sweeps=33, hook_rounds=15,
                              sync_rounds=1), 32),
    "kron-logn21": ((2048, 88064, 86),
                    dict(hook_ops=528384, jump_ops=204800, jump_sweeps=100,
                         hook_rounds=87, sync_rounds=1), 99),
}


@pytest.mark.parametrize("name", list(STANDINS))
def test_table1_standins_reproduce_reference_counters(name):
    shape, counters, scan_sweeps = STANDINS[name]
    g = DeviceGraph.from_host(table1_scaled(name, scale=0.002, seed=1),
                              device="cpu")
    assert (g.num_nodes, g.true_edges, g.plan.num_segments) == shape
    adaptive = tcc.solve_static(g, method="adaptive")
    fused = tcc.solve_static(g, method="pallas_fused")
    assert adaptive.work.as_ints() == counters
    assert fused.work.as_ints() == counters
    assert torch.equal(adaptive.labels, fused.labels)
    np.testing.assert_array_equal(
        fused.labels.numpy(),
        connected_components_scipy(g.edges.numpy(), g.num_nodes))
    segs = tr.pad_and_segment(g.edges, g.plan)
    counts = tr.segment_true_counts(g.true_edges, g.plan)
    _, sweeps = fused_segment_scan(
        torch.arange(g.num_nodes, dtype=torch.int32), segs, counts)
    assert int(sweeps.sum()) == scan_sweeps


@pytest.mark.parametrize("method", ("auto", "sampled", "sampled_fused"))
def test_unported_methods_raise(monkeypatch, method):
    """The methods that route past the static engines (the method policy
    and the two sampled engines): labels and counters equal the
    reference's on chain-17 and a few other corpus graphs, each side's
    default autotune cache cold."""
    from repro.connectivity import policy as jpolicy
    from repro_torch.connectivity import policy as tpolicy
    monkeypatch.setattr(jpolicy, "_default_cache", jpolicy.AutotuneCache())
    monkeypatch.setattr(tpolicy, "_default_cache", tpolicy.AutotuneCache())
    for name in ("chain-17", "star-13", "two-cliques-bridge", "er-mid",
                 "powerlaw-256"):
        _, n, edges = CASES[IDS.index(name)]
        want = jcc.solve_static(edges, n, method)
        got = tcc.solve_static(edges, n, method, device="cpu")
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels), err_msg=name)
        assert got.work.as_ints() == _work(want.work), name


def test_unknown_methods_raise():
    _, n, edges = CASES[IDS.index("chain-17")]
    with pytest.raises(ValueError):
        tcc.solve_static(edges, n, "no-such-method", device="cpu")
    with pytest.raises(ValueError):
        tcc.solve_hostloop(edges, n, "adaptive", device="cpu")
