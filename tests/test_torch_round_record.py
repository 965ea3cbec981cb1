"""The one segment scan and the one cleanup loop of
``repro_torch.core.rounds`` under each recording mode of its ops: no
recording (labels alone), parent edges, and parent edges with their log
rows. Labels and the five counters are equal across the modes, and each
forest mode equals the reference's own forest composition. Then the
host reads each engine path makes, by site and count, pinned to what
the engine made before the recording modes shared one loop."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.core import rounds as jr
from repro.core.segmentation import plan_segmentation as jplan
from repro_torch.core import cc, rounds as tr
from repro_torch.core.incremental import DynamicCC
from repro_torch.core.segmentation import plan_segmentation as tplan
from repro_torch.graphs.device import DeviceGraph
from repro_torch.obs import trace as obs

GRAPHS = {name: (n, edges) for name, n, edges in corpus()
          if name in ("duplicate-edge", "chain-17", "two-cliques-bridge",
                      "er-mid", "powerlaw-256", "pow2-E17")}
MODES = ("none", "parents", "parents+rows")


def _ints(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


def _run(mode: str, n: int, edges: np.ndarray, lift: int):
    """(labels, counters, tables) of the Fig. 4 pipeline over ``edges``
    in three segments, recording ``mode``; with the reference's tables
    for the same call where the mode records."""
    plan = tplan(edges.shape[0], n, 3)
    e = torch.from_numpy(edges)
    if mode == "none":
        pi, work = tr.adaptive_rounds(e, n, plan, lift_steps=lift)
        return pi, work.as_ints(), (), ()
    if mode == "parents":
        pi, parents, work = tr.forest_adaptive_rounds(e, n, plan,
                                                      lift_steps=lift)
        want = jr.forest_adaptive_rounds(
            jnp.asarray(edges), n, jplan(edges.shape[0], n, 3),
            lift_steps=lift)
        return pi, work.as_ints(), (pi, parents), want[:2] + (
            _ints(want[2]),)
    # the segments' rows as one packed log, ids by row, padding id -1
    packed = tr.pad_and_segment(e, plan).reshape(-1, 2)
    ids = torch.full((packed.shape[0],), -1, dtype=torch.int32)
    ids[:edges.shape[0]] = torch.arange(edges.shape[0], dtype=torch.int32)
    pi0 = torch.arange(n, dtype=torch.int32)
    pi, parents, eidx, work = tr.forest_scan_rounds_ids(
        pi0, tr.empty_forest(n), tr.empty_forest_idx(n), packed, ids,
        edges.shape[0], tr.WorkCounters.zeros("cpu"), lift_steps=lift,
        segment_size=plan.segment_size)
    want = jr.forest_scan_rounds_ids(
        jnp.asarray(pi0.numpy()), jr.empty_forest(n), jr.empty_forest_idx(n),
        jnp.asarray(packed.numpy()), jnp.asarray(ids.numpy()),
        edges.shape[0], jr.WorkCounters.zeros(), lift_steps=lift,
        segment_size=plan.segment_size)
    return pi, work.as_ints(), (pi, parents, eidx), want[:3] + (
        _ints(want[3]),)


@pytest.mark.parametrize("lift", (0, 2))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_recording_modes_share_labels_and_counters(name, mode, lift):
    """One loop, three recording modes: labels and all five counters
    equal the unrecorded pipeline's, and a forest mode's labels, tables
    and counters equal the reference's forest composition."""
    n, edges = GRAPHS[name]
    base_pi, base_work, _, _ = _run("none", n, edges, lift)
    pi, work, got, want = _run(mode, n, edges, lift)
    assert torch.equal(pi, base_pi)
    assert work == base_work
    for g, w in zip(got, want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if want:
        assert work == want[-1]
        parents = got[1].numpy()
        # a spanning forest: one recorded row per retired root
        assert int((parents[:, 0] >= 0).sum()) == \
            n - np.unique(base_pi.numpy()).size


# -- the host reads of each engine path ---------------------------------------

V = 400


def _edges(e: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, (e, 2)).astype(
        np.int32)


def _reads(fn) -> dict:
    """The ``read.<site>`` counts that ``fn()`` adds."""
    tracer = obs.tracer()
    before = dict(tracer.counters)
    fn()
    return {k: v - before.get(k, 0) for k, v in tracer.counters.items()
            if k.startswith("read.") and v != before.get(k, 0)}


def _dynamic() -> DynamicCC:
    dyn = DynamicCC(V, device="cpu")
    dyn.insert(_edges(360, 1))
    dyn.insert(_edges(120, 2))
    return dyn


def _dels() -> DeviceGraph:
    return DeviceGraph.from_edges(_edges(360, 1)[::4], V, device="cpu")


def _solve():
    return _reads(lambda: cc.solve_static(
        torch.from_numpy(_edges(1200, 4)), V, method="adaptive",
        device="cpu"))


def _scoped_delete():
    dyn = _dynamic()
    return _reads(lambda: dyn.delete_graph(_dels()))


def _forest_delete():
    dyn = _dynamic()
    assert dyn.forest_valid
    return _reads(lambda: dyn.delete_graph_forest(_dels()))


def _forest_rebuild():
    dyn = _dynamic()
    dyn.tombstone_graph(_dels())
    assert not dyn.forest_valid
    return _reads(dyn.ensure_forest)


# the sites and counts each path read before the recording modes shared
# one loop
READS = {
    "adaptive solve": (_solve, {
        "read.scan_counts": 1, "read.sweep": 18, "read.consistent": 2}),
    "scoped delete tick": (_scoped_delete, {
        "read.delete_hits": 1, "read.scoped_rows": 1,
        "read.scoped_counts": 1, "read.sweep": 14, "read.consistent": 3}),
    "forest delete tick": (_forest_delete, {
        "read.tree_hits": 1, "read.pack": 2, "read.forest_counts": 1,
        "read.sweep": 14, "read.consistent": 6}),
    "forest rebuild": (_forest_rebuild, {
        "read.pack": 1, "read.forest_counts": 1, "read.sweep": 14,
        "read.consistent": 3}),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_host_read_sites_and_counts_are_pinned(case):
    run, want = READS[case]
    assert run() == want
