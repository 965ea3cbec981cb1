"""The benchmark's device generators against the program's host
generators at a small size: the same vertex count, edge count, degree
and component regime; and the same graph for the same seed."""
import numpy as np
import pytest
import torch

import _ccbench_tiny  # noqa: F401  (import path)
from ccbench import harness, reference
from ccbench.drivers.churn import distinct_undirected
from repro_torch.graphs import generators as host

GEN_DIR = _ccbench_tiny.ROOT / "ccbench" / "generators"


def _gen(name):
    return harness.load_module(GEN_DIR / f"{name}.py", f"test_gen_{name}")


def _regime(edges: np.ndarray, n: int) -> dict:
    deg = np.bincount(edges.reshape(-1), minlength=n)
    labels, _ = reference.cc_labels(torch.as_tensor(edges, dtype=torch.int32),
                                    n)
    sizes = np.bincount(labels.numpy(), minlength=n)
    return {"mean_degree": 2 * edges.shape[0] / n,
            "skew": deg.max() / deg.mean(),
            "giant": sizes.max() / n,
            "isolated": float((deg == 0).mean()),
            "max_degree": int(deg.max())}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_grid_road_matches_host_generator(seed):
    side = 96
    params = {"side": side, "drop_prob": 0.35, "extra_prob": 0.02}
    edges, n = _gen("grid_road").generate(
        params, harness.generator(torch.device("cpu"), seed, "g"), "cpu")
    ref = host.grid_road(side, extra_prob=0.02, seed=seed)
    assert n == ref.num_nodes == side * side
    assert edges.dtype == torch.int32 and edges.shape[1] == 2
    grid = 2 * side * (side - 1)
    assert edges.shape[0] == round(0.65 * grid) + int(0.02 * n)
    # the host's Bernoulli count lies within a few sigma of the exact one
    assert abs(ref.edges.shape[0] - edges.shape[0]) < 5 * (grid * .35 * .65) ** .5
    got, want = _regime(edges.numpy(), n), _regime(ref.edges, n)
    assert got["max_degree"] <= 6 and want["max_degree"] <= 6
    assert abs(got["mean_degree"] - want["mean_degree"]) < 0.05
    assert abs(got["giant"] - want["giant"]) < 0.15
    assert abs(got["isolated"] - want["isolated"]) < 0.02
    # grid edges join neighbours, shortcuts the next diagonal
    d = (edges[:, 1] - edges[:, 0]).unique().tolist()
    assert sorted(d) == [1, side, side + 1]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_rmat_matches_host_generator(seed):
    params = {"scale": 11, "edge_factor": 16, "a": 0.57, "b": 0.19,
              "c": 0.19}
    edges, n = _gen("rmat").generate(
        params, harness.generator(torch.device("cpu"), seed, "g"), "cpu")
    ref = host.rmat(11, 16, seed=seed)
    assert n == ref.num_nodes == 2048
    assert edges.shape == (2048 * 16, 2) and edges.dtype == torch.int32
    assert int(edges.min()) >= 0 and int(edges.max()) < n
    got, want = _regime(edges.numpy(), n), _regime(ref.edges, n)
    # the power-law regime the policy's sampling rule keys on
    assert got["skew"] > 8 and want["skew"] > 8
    assert 0.5 < got["skew"] / want["skew"] < 2
    assert abs(got["giant"] - want["giant"]) < 0.05
    assert abs(got["isolated"] - want["isolated"]) < 0.05
    # vertex 0 is the hub: no relabelling, as the host generator
    deg = np.bincount(edges.numpy().reshape(-1), minlength=n)
    assert deg.argmax() == 0


@pytest.mark.parametrize("name,params", [
    ("grid_road", {"side": 30, "drop_prob": 0.35, "extra_prob": 0.02}),
    ("rmat", {"scale": 8, "edge_factor": 8, "a": 0.57, "b": 0.19,
              "c": 0.19})])
def test_same_seed_same_graph(name, params):
    cpu = torch.device("cpu")
    a, _ = _gen(name).generate(params, harness.generator(cpu, 3, "x"), cpu)
    b, _ = _gen(name).generate(params, harness.generator(cpu, 3, "x"), cpu)
    c, _ = _gen(name).generate(params, harness.generator(cpu, 4, "x"), cpu)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_rmat_distinct_is_simple_with_an_exact_count(seed):
    params = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19,
              "c": 0.19, "distinct": True, "num_edges": 9000}
    cpu = torch.device("cpu")
    gen = _gen("rmat")
    edges, n = gen.generate(params, harness.generator(cpu, seed, "g"), cpu)
    assert n == 1024 and edges.shape == (9000, 2)
    assert edges.dtype == torch.int32
    assert bool((edges[:, 0] < edges[:, 1]).all())     # (min, max), no loop
    assert distinct_undirected(edges).shape[0] == 9000  # no duplicate
    # the same rows as the raw draw's distinct edges, in a drawn order
    raw, _ = gen.generate({**params, "distinct": False},
                          harness.generator(cpu, seed, "g"), cpu)
    every = distinct_undirected(raw)
    assert every.shape[0] > 9000
    keys = lambda e: set((e[:, 0].long() * n + e[:, 1].long()).tolist())
    assert keys(edges) <= keys(every)
    assert not torch.equal(edges, every[:9000])
    with pytest.raises(ValueError):
        gen.generate({**params, "num_edges": every.shape[0] + 1},
                     harness.generator(cpu, seed, "g"), cpu)


def test_distinct_undirected():
    e = torch.tensor([[3, 1], [1, 3], [2, 2], [0, 5], [5, 0], [4, 1]],
                     dtype=torch.int32)
    got = distinct_undirected(e)
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 5], [1, 3], [1, 4]]


def test_seed_for_spreads_large_seeds():
    seeds = {harness.seed_for(s, "graph") for s in
             (0, 1, 2**31, 2**31 + 1, 2**33 + 7, -1)}
    assert len(seeds) == 6
    assert all(0 <= s < 2**63 for s in seeds)
    assert harness.seed_for(5, "a") == harness.seed_for(5, "a")
    assert harness.seed_for(5, "a") != harness.seed_for(5, "b")
