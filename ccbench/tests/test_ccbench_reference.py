"""The plain reference against a union-find, and its control."""
import numpy as np
import pytest
import torch

import _ccbench_tiny  # noqa: F401  (import path)
from ccbench import reference


def union_find(edges: np.ndarray, n: int) -> np.ndarray:
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(x) for x in range(n)], np.int32)


def _graphs():
    rng = np.random.default_rng(5)
    idx = np.arange(99)
    yield "chain", np.stack([idx, idx + 1], 1), 100
    yield "chain_reversed", np.ascontiguousarray(
        np.stack([idx + 1, idx], 1)[::-1]), 100
    yield "star", np.stack([np.full(63, 17), np.delete(np.arange(64), 17)],
                           1), 64
    cliques = [np.stack(np.triu_indices(6, 1), 1) + 6 * k for k in range(5)]
    yield "cliques", np.concatenate(cliques), 32
    yield "empty", np.zeros((0, 2), np.int64), 9
    yield "self_loops_and_duplicates", np.array(
        [[3, 3], [1, 2], [2, 1], [1, 2], [7, 0]]), 8
    for k in range(4):
        n = int(rng.integers(2, 400))
        m = int(rng.integers(0, 2 * n))
        yield f"random{k}", rng.integers(0, n, (m, 2)), n
    perm = rng.permutation(200)
    yield "shuffled_chain", np.stack([perm[:-1], perm[1:]], 1), 200


@pytest.mark.parametrize("name,edges,n", list(_graphs()),
                         ids=[g[0] for g in _graphs()])
@pytest.mark.parametrize("block_rows", [1 << 25, 7])
def test_reference_equals_union_find(name, edges, n, block_rows):
    got, _ = reference.cc_labels(torch.as_tensor(edges, dtype=torch.int32),
                                 n, block_rows=block_rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), union_find(edges, n))


@pytest.mark.parametrize("name,edges,n", [g for g in _graphs()
                                          if g[0] in ("chain", "star",
                                                      "shuffled_chain")])
def test_stop_short_control_is_wrong(name, edges, n):
    t = torch.as_tensor(edges, dtype=torch.int32)
    want, rounds = reference.cc_labels(t, n)
    short, _ = reference.cc_labels(t, n, stop_short=True)
    assert rounds >= 1
    assert reference.mismatches(short, want) > 0


def test_mismatches_counts_vertices_and_shape():
    want = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    assert reference.mismatches(want.clone(), want) == 0
    assert reference.mismatches(torch.tensor([0, 1, 2, 0]), want) == 2
    assert reference.mismatches(torch.tensor([0, 0, 2]), want) == 4
