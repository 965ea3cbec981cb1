"""repro_torch's sampled engine against repro.core.sampled.solve_sampled:
labels, the ``parents`` table, all five WorkCounters and every ``stats``
entry equal over the named corpus with and without the fused residue
scan; ``sampled_fused`` equal to ``sampled`` in labels and counters; the
Table I stand-ins at scale 0.002 give the reference's constants
(computed live beside the recorded ones, so a stale constant fails
loudly); the phases' spans and counters land in the port's tracer.
Integer work throughout: the tolerance is 0."""
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.core import sampled as jsampled
from repro.graphs.device import DeviceGraph as JDeviceGraph
from repro.graphs.generators import table1_scaled
from repro_torch.core import cc as tcc
from repro_torch.core import sampled as tsampled
from repro_torch.core.unionfind import connected_components_scipy
from repro_torch.graphs.device import DeviceGraph
from repro_torch.obs import trace as tobs

CASES = corpus()
IDS = [c[0] for c in CASES]


def _ints(d) -> dict:
    return {k: int(v) for k, v in d.items()}


def _check_equal(got, want):
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.parents.numpy(),
                                  np.asarray(want.parents))
    assert got.work.as_ints() == _ints(want.work._asdict())
    assert _ints(got.stats) == _ints(want.stats)
    for k, v in got.stats.items():
        # the phase split of hook_ops counts as work does, in int64
        want_dtype = torch.int64 if k.endswith("hook_ops") else torch.int32
        assert v.dtype == want_dtype and v.dim() == 0


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
@pytest.mark.parametrize("fused", (False, True))
def test_solve_sampled_matches_reference(fused, name, n, edges):
    want = jsampled.solve_sampled(edges, n, fused=fused)
    got = tsampled.solve_sampled(edges, n, fused=fused, device="cpu")
    _check_equal(got, want)
    if fused:
        plain = tsampled.solve_sampled(edges, n, device="cpu")
        assert torch.equal(got.labels, plain.labels)
        assert got.work.as_ints() == plain.work.as_ints()


# table1_scaled(name, scale=0.002, seed=1), the sampled engine:
# (hook_ops, n_residue, giant_size) as BENCH_sampled.json records them
SAMPLED_STANDINS = {
    "usa-osm": (547122, 2069, 6917),
    "euro-osm-karls": (3969060, 15445, 25936),
    "soc-live-journal": (85488, 0, 7514),
    "kron-logn21": (22092, 0, 1911),
}


@pytest.mark.parametrize("name", list(SAMPLED_STANDINS))
def test_table1_standins_reproduce_sampled_constants(name):
    host = table1_scaled(name, scale=0.002, seed=1)
    jg = JDeviceGraph.from_edges(host.edges, host.num_nodes)
    g = DeviceGraph.from_host(host, device="cpu")
    hook_ops, n_residue, giant = SAMPLED_STANDINS[name]
    oracle = connected_components_scipy(host.edges, host.num_nodes)
    plain = None
    for fused in (False, True):
        want = jsampled.solve_sampled(jg, fused=fused)
        got = tsampled.solve_sampled(g, fused=fused)
        _check_equal(got, want)
        assert (int(want.work.hook_ops), int(want.stats["n_residue"]),
                int(want.stats["giant_size"])) == (hook_ops, n_residue,
                                                    giant)
        np.testing.assert_array_equal(got.labels.numpy(), oracle)
        if plain is None:
            plain = got
        else:
            assert got.work.as_ints() == plain.work.as_ints()
    # solve_static routes both sampled methods to the engine
    for method in tcc.SAMPLED_METHODS:
        res = tcc.solve_static(g, method=method)
        assert res.work.as_ints() == plain.work.as_ints()


def test_giant_component_ties_go_to_the_first_label():
    """Two components of equal size after sampling: the census argmax
    takes the lower label, as jnp.argmax does."""
    edges = np.array([[0, 1], [1, 2], [3, 4], [4, 5], [6, 7]], np.int32)
    want = jsampled.solve_sampled(edges, 8)
    got = tsampled.solve_sampled(edges, 8, device="cpu")
    _check_equal(got, want)
    assert (int(got.stats["giant_label"]), int(got.stats["giant_size"])) \
        == (0, 3)
    edges = np.array([[5, 6], [6, 7], [0, 1], [1, 2]], np.int32)
    got = tsampled.solve_sampled(edges, 8, device="cpu")
    assert (int(got.stats["giant_label"]), int(got.stats["giant_size"])) \
        == (0, 3)
    _check_equal(got, jsampled.solve_sampled(edges, 8))


def test_padded_graph_matches_reference():
    """Rows past the true count are never sampled and never billed."""
    _, n, edges = CASES[IDS.index("powerlaw-64")]
    jg = JDeviceGraph.from_edges(edges, n).pad_pow2(min_rows=1024)
    tg = DeviceGraph.from_reference(np.asarray(jg.edges), jg.num_nodes,
                                    jg.true_edges_static,
                                    jg.plan.num_segments, device="cpu")
    for fused in (False, True):
        _check_equal(tsampled.solve_sampled(tg, fused=fused),
                     jsampled.solve_sampled(jg, fused=fused))


def test_spans_and_counters_land_in_the_tracer():
    _, n, edges = CASES[IDS.index("powerlaw-256")]
    tracer = tobs.tracer()
    tracer.reset()
    tobs.enable()
    try:
        res = tsampled.solve_sampled(edges, n, device="cpu")
    finally:
        tobs.disable()
    # the port's own read counters and engine spans (``PORT_ONLY``) have
    # no counterpart in the reference: the rest is compared exactly
    names = [ev["name"] for ev in tracer.log.events()
             if not ev["name"].startswith(tobs.PORT_ONLY)]
    assert names == ["sampled.sample_phase", "sampled.residue_scan"]
    assert tracer.log.events()[0]["tags"] == {"num_nodes": n, "k": 2}
    counters = {k: v for k, v in tracer.counters.items()
                if not k.startswith(tobs.PORT_ONLY)}
    assert counters == {
        "sampled.solves": 1,
        "sampled.hook_ops.sample": int(res.stats["sample_hook_ops"]),
        "sampled.hook_ops.residue": int(res.stats["residue_hook_ops"])}
    # counters are always on; spans only while enabled
    tsampled.solve_sampled(edges, n, device="cpu")
    assert tracer.counters["sampled.solves"] == 2
    assert len(tracer.log) == 2
    tracer.reset()
