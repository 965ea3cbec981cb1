"""repro_torch.core.rounds against repro.core.rounds over the named
corpus: the same numpy inputs through both, exact equality of π and of
all five WorkCounters (integer work: the tolerance is 0)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _graphgen import corpus
from repro.core import rounds as jr
from repro.core.segmentation import plan_segmentation as jplan
from repro_torch.core import rounds as tr
from repro_torch.core.segmentation import plan_segmentation as tplan

# cases with at least one vertex and one edge (the solves short-circuit
# the others before any round runs)
CASES = [c for c in corpus() if c[1] > 0 and c[2].shape[0] > 0]
IDS = [c[0] for c in CASES]


# the reference's compositions, jitted once per shape (one compile
# instead of one per traced loop body)
@functools.partial(jax.jit, static_argnames=("count_syncs", "bill"))
def _j_compress(pi, *, count_syncs, bill):
    return jr.compress(pi, jr.WorkCounters.zeros(), count_syncs=count_syncs,
                       bill_nodes=bill)


@jax.jit
def _j_segment_scan(pi, segments, counts):
    return jr.segment_scan(pi, segments, jr.jnp_round_ops(2),
                           jr.WorkCounters.zeros(), true_counts=counts)


@functools.partial(jax.jit, static_argnames=("lift",))
def _j_cleanup(pi, edges, *, lift):
    return jr.cleanup_rounds(pi, edges, jr.jnp_round_ops(lift),
                             jr.WorkCounters.zeros())


@functools.partial(jax.jit, static_argnums=(1, 2))
def _j_adaptive(edges, n, plan):
    return jr.adaptive_rounds(edges, n, plan)


def _forest(n: int, seed: int) -> np.ndarray:
    """A random parent array with pi[x] <= x (what every round keeps)."""
    rng = np.random.default_rng(seed)
    return np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)


def _work(w) -> dict:
    return {k: int(v) for k, v in w._asdict().items()}


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_hook_edges_matches_reference(name, n, edges):
    pi = _forest(n, 1)
    for lift in (0, 2):
        _eq(tr.hook_edges(torch.from_numpy(pi), torch.from_numpy(edges),
                          lift_steps=lift),
            jr.hook_edges(jnp.asarray(pi), jnp.asarray(edges),
                          lift_steps=lift))


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_compress_matches_reference(name, n, edges):
    pi = _forest(n, 2)
    for count_syncs, bill in ((False, None), (True, max(1, n // 2))):
        tp, tw = tr.compress(torch.from_numpy(pi),
                             tr.WorkCounters.zeros("cpu"),
                             count_syncs=count_syncs, bill_nodes=bill)
        jp, jw = _j_compress(jnp.asarray(pi), count_syncs=count_syncs,
                             bill=bill)
        _eq(tp, jp)
        assert tw.as_ints() == _work(jw)
    assert tr.edges_consistent(tp, torch.from_numpy(edges)) == \
        bool(jr.edges_consistent(jp, jnp.asarray(edges)))


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_segment_scan_matches_reference(name, n, edges):
    for s in (1, 3):
        tplan_, jplan_ = tplan(edges.shape[0], n, s), jplan(edges.shape[0], n, s)
        tseg = tr.pad_and_segment(torch.from_numpy(edges), tplan_)
        jseg = jr.pad_and_segment(jnp.asarray(edges), jplan_)
        _eq(tseg, jseg)
        true = max(0, edges.shape[0] - 2)         # bill a padded tail
        tc = tr.segment_true_counts(true, tplan_)
        _eq(tc, jr.segment_true_counts(true, jplan_))
        tp, tw = tr.segment_scan(torch.arange(n, dtype=torch.int32), tseg,
                                 tr.torch_round_ops(2),
                                 tr.WorkCounters.zeros("cpu"), true_counts=tc)
        jp, jw = _j_segment_scan(jnp.arange(n, dtype=jnp.int32), jseg,
                                 jr.segment_true_counts(true, jplan_))
        _eq(tp, jp)
        assert tw.as_ints() == _work(jw)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_cleanup_rounds_matches_reference(name, n, edges):
    for lift in (0, 2):
        tp, tw = tr.cleanup_rounds(torch.arange(n, dtype=torch.int32),
                                   torch.from_numpy(edges),
                                   tr.torch_round_ops(lift),
                                   tr.WorkCounters.zeros("cpu"))
        jp, jw = _j_cleanup(jnp.arange(n, dtype=jnp.int32),
                            jnp.asarray(edges), lift=lift)
        _eq(tp, jp)
        assert tw.as_ints() == _work(jw)


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_adaptive_rounds_matches_reference(name, n, edges):
    # two segments (the solve tests cover the heuristic's count)
    tp, tw = tr.adaptive_rounds(torch.from_numpy(edges), n,
                                tplan(edges.shape[0], n, 2))
    jp, jw = _j_adaptive(jnp.asarray(edges), n, jplan(edges.shape[0], n, 2))
    _eq(tp, jp)
    assert tw.as_ints() == _work(jw)


def test_compress_fuel_matches_reference():
    for v in (0, 1, 2, 3, 17, 1024, 1025, 23_990_404):
        assert tr.compress_fuel(v) == jr.compress_fuel(v)


def test_work_counters_count_past_int32():
    """The port's counters are int64: past 2^31 - 1, where the
    reference's int32 counters wrap, they stay exact."""
    w = tr.WorkCounters.zeros("cpu").add(jump_ops=2**31 - 1)
    w = w.add(jump_ops=2, hook_ops=2**32 + 5)
    w = w.add(hook_ops=torch.tensor(2**31 - 1, dtype=torch.int32),
              jump_sweeps=torch.tensor(2**40, dtype=torch.int64))
    assert all(v.dtype == torch.int64 for v in w)
    assert w.as_ints() == {"hook_ops": 2**32 + 5 + 2**31 - 1,
                           "jump_ops": 2**31 + 1, "jump_sweeps": 2**40,
                           "hook_rounds": 0, "sync_rounds": 0}
    # a compress of a 3-chain bills bill_nodes a sweep: 3 sweeps (the
    # last changes nothing) at 2^30 each pass 2^31
    pi = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    for bill in (2**30, torch.tensor(2**30, dtype=torch.int32)):
        flat, w = tr.compress(pi, tr.WorkCounters.zeros("cpu"),
                              bill_nodes=bill)
        assert flat.tolist() == [0, 0, 0, 0]
        assert w.jump_sweeps.item() == 3
        assert w.jump_ops.item() == 3 * 2**30
        assert w.jump_ops.dtype == torch.int64
