"""The plain versions behind repro_torch's three kernels against the
reference's Pallas kernels, run as the reference's own tests run them on
the CPU (``interpret=True``). Same numpy inputs through both; exact
integer equality (tolerance 0). The kernels themselves run only on the
card: ``tests/test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as jr
from repro.graphs.generators import table1_scaled
from repro.kernels.cc_fused.cc_fused import cc_fused_pallas
from repro.kernels.cc_fused.ref import ref_segment_scan as jref_segment_scan
from repro.kernels.hook import ops as jhook_ops, ref as jhook_ref
from repro.kernels.multi_jump import ops as jmj_ops, ref as jmj_ref
from repro_torch.core import rounds as tr
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.kernels.cc_fused import ref as cc_ref
from repro_torch.kernels.cc_fused.ops import fused_segment_scan
from repro_torch.kernels.hook import ref as hook_ref
from repro_torch.kernels.hook.ops import hook_edges_pallas
from repro_torch.kernels.multi_jump import ref as mj_ref
from repro_torch.kernels.multi_jump.ops import full_compress, multi_jump


def _forest(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)


def _edges(n: int, e: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n, (e, 2)).astype(np.int32)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# (V, E, true E, segments): an exact-sized graph, a padded one (slots
# past the true count are masked), and the kron stand-in's shape class
SCANS = [(64, 200, 200, 3), (100, 256, 180, 4), (2048, 88064, 88064, 86)]


@pytest.mark.parametrize("v,e,true,s", SCANS)
@pytest.mark.parametrize("lift", (0, 2))
def test_cc_fused_plain_matches_pallas_interpret(v, e, true, s, lift):
    if e == 88064:
        g = table1_scaled("kron-logn21", scale=0.002, seed=1)
        edges = np.asarray(g.edges, np.int32)
    else:
        edges = _edges(v, true, seed=v)
        edges = np.concatenate([edges, np.zeros((e - true, 2), np.int32)])
    plan = plan_segmentation(e, v, s)
    segs = tr.pad_and_segment(torch.from_numpy(edges), plan)
    counts = tr.segment_true_counts(true, plan)
    pi0 = torch.arange(v, dtype=torch.int32)
    fuel = tr.compress_fuel(v)
    got_pi, got_sw = cc_ref.ref_segment_scan(pi0, segs, counts,
                                             lift_steps=lift, fuel=fuel)
    want_pi, want_sw = cc_fused_pallas(
        jnp.asarray(pi0.numpy()), jnp.asarray(segs.numpy()),
        jnp.asarray(counts.numpy()), lift_steps=lift, fuel=fuel,
        interpret=True)
    _eq(got_pi, want_pi)
    _eq(got_sw, want_sw)
    # the wrapper on CPU tensors is the plain version
    w_pi, w_sw = fused_segment_scan(pi0, segs, counts, lift_steps=lift)
    assert torch.equal(w_pi, got_pi) and torch.equal(w_sw, got_sw)


def test_cc_fused_plain_with_exhausted_fuel_matches_pallas():
    """A chain needs more sweeps than fuel=1 allows: the result is the
    last sweep's output and every segment reports fuel sweeps."""
    n = 40
    edges = np.stack([np.arange(1, n), np.arange(0, n - 1)], 1).astype(np.int32)
    plan = plan_segmentation(edges.shape[0], n, 2)
    segs = tr.pad_and_segment(torch.from_numpy(edges), plan)
    counts = tr.segment_true_counts(edges.shape[0], plan)
    pi0 = torch.from_numpy(_forest(n, 5))
    got = cc_ref.ref_segment_scan(pi0, segs, counts, lift_steps=0, fuel=1)
    want = cc_fused_pallas(jnp.asarray(pi0.numpy()), jnp.asarray(segs.numpy()),
                           jnp.asarray(counts.numpy()), lift_steps=0, fuel=1,
                           interpret=True)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("tile", (8, 32, 100))
@pytest.mark.parametrize("lift", (0, 2))
def test_hook_plain_matches_pallas_interpret(tile, lift):
    n, e = 200, 500                 # 500 is not a tile multiple: padded
    pi = _forest(n, tile)
    edges = _edges(n, e, seed=tile + 1)
    got = hook_edges_pallas(torch.from_numpy(pi), torch.from_numpy(edges),
                            edge_tile=tile, lift_steps=lift)
    _eq(got, jhook_ops.hook_edges_pallas(jnp.asarray(pi), jnp.asarray(edges),
                                         edge_tile=tile, lift_steps=lift,
                                         interpret=True))
    pad = (-e) % tile
    padded = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    _eq(hook_ref.ref_hook_tiled(torch.from_numpy(pi),
                                torch.from_numpy(padded), tile, lift),
        jhook_ref.ref_hook_tiled(jnp.asarray(pi), jnp.asarray(padded),
                                 tile, lift))


@pytest.mark.parametrize("lift", (0, 2))
def test_hook_round_plain_matches_reference(lift):
    n = 150
    pi, edges = _forest(n, 7), _edges(n, 400, seed=8)
    _eq(hook_ref.ref_hook_round(torch.from_numpy(pi), torch.from_numpy(edges),
                                lift),
        jhook_ref.ref_hook_round(jnp.asarray(pi), jnp.asarray(edges), lift))


@pytest.mark.parametrize("n,tile", ((256, 128), (300, 128), (1000, 64),
                                    (77, 8)))
def test_multi_jump_sweep_plain_matches_pallas_interpret(n, tile):
    pi = _forest(n, n)
    got = multi_jump(torch.from_numpy(pi), tile=tile, rounds=2)
    _eq(got, jmj_ops.multi_jump(jnp.asarray(pi), tile=tile, rounds=2,
                                interpret=True))
    if n % tile == 0:
        _eq(mj_ref.ref_multi_jump_sweep(torch.from_numpy(pi), tile, 2),
            jmj_ref.ref_multi_jump_sweep(jnp.asarray(pi), tile, 2))


@pytest.mark.parametrize("seed", range(3))
def test_full_compress_plain_matches_reference(seed):
    n = 257
    pi = _forest(n, 100 + seed)
    got = full_compress(torch.from_numpy(pi), tile=128)
    _eq(got, jmj_ops.full_compress(jnp.asarray(pi), tile=128, interpret=True))
    _eq(mj_ref.ref_full_compress(torch.from_numpy(pi)),
        jmj_ref.ref_full_compress(jnp.asarray(pi)))


def test_full_compress_plain_flattens_chain():
    n = 300
    chain = np.maximum(np.arange(n) - 1, 0).astype(np.int32)
    got = full_compress(torch.from_numpy(chain), tile=128)
    _eq(got, jmj_ops.full_compress(jnp.asarray(chain), tile=128,
                                   interpret=True))
    assert bool((got == 0).all())


def test_cc_fused_plain_matches_reference_jnp_scan():
    """The plain version's sweeps sum to the reference's jnp
    segment-scan jump_sweeps (what ``pallas_fused`` bills)."""
    g = table1_scaled("soc-live-journal", scale=0.002, seed=1)
    edges = np.asarray(g.edges, np.int32)
    plan = plan_segmentation(edges.shape[0], g.num_nodes, None)
    segs = tr.pad_and_segment(torch.from_numpy(edges), plan)
    counts = tr.segment_true_counts(edges.shape[0], plan)
    _, sweeps = cc_ref.ref_segment_scan(
        torch.arange(g.num_nodes, dtype=torch.int32), segs, counts)
    _, jw = jref_segment_scan(jnp.arange(g.num_nodes, dtype=jnp.int32),
                             jnp.asarray(segs.numpy()),
                             jnp.asarray(counts.numpy()))
    assert int(sweeps.sum()) == int(jw.jump_sweeps) == 32
    assert jr.compress_fuel(g.num_nodes) == tr.compress_fuel(g.num_nodes)


def _depth(pi: np.ndarray) -> int:
    """The largest number of parent steps from a vertex to its root."""
    nxt = pi.copy()
    dist = (nxt != np.arange(pi.shape[0])).astype(np.int64)
    while True:
        step = dist[nxt]
        if not step.any():
            return int(dist.max())
        dist = dist + step
        nxt = nxt[nxt]


def _counted_sweeps(pi: torch.Tensor, tile: int) -> tuple[torch.Tensor, int]:
    """Sequential sweeps (2 rounds) until one changes nothing, uncapped:
    the fixpoint and the sweeps taken, the last (unchanged) one
    included."""
    sweeps = 0
    while True:
        nxt = mj_ref.ref_multi_jump_sweep(pi, tile, 2)
        sweeps += 1
        if torch.equal(nxt, pi):
            return pi, sweeps
        pi = nxt


def _chain(n: int) -> np.ndarray:
    return np.maximum(np.arange(n) - 1, 0).astype(np.int32)


def _reversed_chain(n: int) -> np.ndarray:
    return np.minimum(np.arange(n) + 1, n - 1).astype(np.int32)


# forests full_compress's fixpoint body is exact on: chains of 2^k
# vertices toward lower ids (as hooks build them) and toward higher ids,
# and random forests of the main path's form (pi[v] <= v)
FIXPOINT_FORESTS = (
    [("chain", 2 ** k) for k in (1, 4, 8, 12, 16)]
    + [("reversed_chain", 2 ** k) for k in (1, 4, 8, 12, 16)]
    + [("forest", n) for n in (257, 4096, 50000)])


def _fixpoint_input(kind: str, n: int) -> np.ndarray:
    if kind == "chain":
        return _chain(n)
    if kind == "reversed_chain":
        return _reversed_chain(n)
    return _forest(n, n)


@pytest.mark.parametrize("tile", (128, 512))
@pytest.mark.parametrize("kind,n", FIXPOINT_FORESTS)
def test_sequential_sweeps_reach_fixpoint_inside_cap(kind, n, tile):
    """The sequential sweeps that full_compress's plain version runs
    reach the fixpoint (every vertex at its root) far inside the 64-sweep
    cap, so the fixpoint body on the card may ignore the sweep order.
    Each of a sweep's two rounds moves a pointer at least as far as its
    target's pointer reached at the sweep's start (values only move up),
    so a sweep at least triples the least distance to the root: the
    fixpoint comes within ceil(log3 depth) sweeps and the next changes
    nothing (at most 21 for any int32 forest). Halving the log2, as if
    each round doubled, does not hold: a chain toward higher ids takes 11
    sweeps at depth 2^16 - 1, because a tile reads the next tile's
    pointers as the last sweep left them."""
    pi = _fixpoint_input(kind, n)
    want = mj_ref.ref_full_compress(torch.from_numpy(pi))
    got, sweeps = _counted_sweeps(torch.from_numpy(pi), tile)
    assert torch.equal(got, want)
    depth = max(_depth(pi), 1)
    assert sweeps <= math.ceil(math.log(depth, 3) - 1e-9) + 1, (sweeps, depth)
    assert torch.equal(mj_ref.ref_multi_jump_sweeps(
        torch.from_numpy(pi), tile, 2, 64), want)
    assert torch.equal(full_compress(torch.from_numpy(pi), tile=tile), want)


@pytest.mark.parametrize("kind,n", [("chain", 4096),
                                    ("reversed_chain", 4096),
                                    ("forest", 4096), ("forest", 1000)])
def test_full_compress_fixpoint_matches_reference_interpret(kind, n):
    """Where interpret mode can afford it, the reference's full_compress
    reaches the same fixpoint."""
    pi = _fixpoint_input(kind, n)
    want = mj_ref.ref_full_compress(torch.from_numpy(pi))
    _eq(want, jmj_ops.full_compress(jnp.asarray(pi), tile=512,
                                    interpret=True))
    _eq(full_compress(torch.from_numpy(pi)), jmj_ref.ref_full_compress(
        jnp.asarray(pi)))
