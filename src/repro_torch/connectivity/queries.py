"""Connectivity queries over a label array, on the device: the port of
``repro.connectivity.queries``.

Every engine converges to canonical min-id labels (``labels[v]`` = min
vertex id of v's component); once that array is on the device, every
connectivity question is a gather, a scatter-add or a sort:

  * ``same_component(labels, pairs)``    — a [Q, 2] batch of "are u and
    v connected?" (one gather and a compare);
  * ``component_size(labels, vertices)`` — per-vertex component sizes
    from a scatter-add census over the labels;
  * ``count_components(labels)``         — distinct-label count by sort
    and boundary count (right for any labelling, canonical or not);
  * ``component_histogram(labels)``      — components per power-of-two
    size bin (census and an exact integer log2 through ``frexp``);
  * ``spanning_forest_stats(labels, parents)`` — validation scalars of a
    recorded spanning forest.

Labels are int32 [V] with values in [0, V). Results stay on the labels'
device; ``to_host`` is the one place an answer crosses to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def to_host(result) -> np.ndarray:
    """The one device-to-host sink for query results."""
    if isinstance(result, torch.Tensor):
        return result.cpu().numpy()
    return np.asarray(result)


def _vertex_ids(ids, n: int, device) -> torch.Tensor:
    """int64 indices into a [n] array, read as the reference's gathers
    read them: a negative id counts from the end, then every id is
    clamped into [0, n - 1]. ``Solver`` validates ids at its boundary;
    these functions clamp, as the reference does."""
    ids = torch.as_tensor(ids, device=device).to(torch.int32).long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids.clamp(0, max(n - 1, 0))


def same_component(labels: torch.Tensor, pairs) -> torch.Tensor:
    """bool [Q]: ``labels[u] == labels[v]`` for every pair (u, v) of the
    int [Q, 2] batch ``pairs``. Out-of-range ids are clamped."""
    ids = _vertex_ids(pairs, labels.shape[0], labels.device).reshape(-1, 2)
    return labels[ids[:, 0]] == labels[ids[:, 1]]


def component_census(labels: torch.Tensor) -> torch.Tensor:
    """int32 [V]: ``census[r]`` = size of the component whose
    representative is ``r`` (0 for other ids).

    The reference scatter-adds a one per vertex. On the device that puts
    every vertex of a giant component on one address, so the census is
    counted from the sorted labels instead: each label's first and last
    positions are written once, by the elements that hold them; every
    other element writes a no-op value to its own position."""
    v = labels.shape[0]
    dev = labels.device
    s = torch.sort(labels).values.long()
    pos = torch.arange(v, device=dev)
    start = torch.ones(v, dtype=torch.bool, device=dev)
    start[1:] = s[1:] != s[:-1]
    last = torch.ones(v, dtype=torch.bool, device=dev)
    last[:-1] = start[1:]
    first = torch.full((v,), v, device=dev).scatter_reduce(
        0, torch.where(start, s, pos), torch.where(start, pos, v),
        reduce="amin")
    end = torch.full((v,), -1, device=dev).scatter_reduce(
        0, torch.where(last, s, pos), torch.where(last, pos, -1),
        reduce="amax")
    return torch.where(end >= 0, end - first + 1, 0).to(torch.int32)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """int32 [V]: the size of every vertex's component."""
    return component_census(labels)[labels.long()]


def component_size(labels: torch.Tensor, vertices) -> torch.Tensor:
    """int32 [Q]: the component size of each queried vertex (ids
    clamped)."""
    ids = _vertex_ids(vertices, labels.shape[0], labels.device).reshape(-1)
    return component_census(labels)[labels[ids].long()]


def _count_components(labels: torch.Tensor) -> torch.Tensor:
    s = torch.sort(labels).values
    return ((s[1:] != s[:-1]).sum() + 1).to(torch.int32)


def count_components(labels: torch.Tensor) -> torch.Tensor:
    """int32 scalar: the number of distinct labels (= components), by
    sort and boundary count, so right for any labelling. Stays on the
    device; ``int(...)`` it to read it."""
    labels = torch.as_tensor(labels)
    if labels.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=labels.device)
    return _count_components(labels)


def spanning_forest_stats(labels: torch.Tensor, parents: torch.Tensor
                          ) -> dict:
    """Validation scalars of a recorded spanning forest (``parents``:
    int32 [V, 2], row r the graph edge whose hook retired root r,
    (-1, -1) for roots), all on the device:

    * ``n_forest_edges`` — rows recorded;
    * ``n_roots`` — V minus the rows recorded;
    * ``n_components`` — distinct labels;
    * ``edges_intra_component`` — every recorded edge joins two vertices
      of one label;
    * ``count_consistent`` — recorded + components == V. With the
      previous check this pins the forest to one tree per component;
      acyclicity itself is proved host-side by the tests."""
    labels = torch.as_tensor(labels)
    dev = labels.device
    parents = torch.as_tensor(parents, device=dev).to(torch.int32)
    parents = parents.reshape(-1, 2)
    v = labels.shape[0]
    if v == 0:
        z = torch.zeros((), dtype=torch.int32, device=dev)
        t = torch.ones((), dtype=torch.bool, device=dev)
        return {"n_forest_edges": z, "n_roots": z, "n_components": z,
                "edges_intra_component": t, "count_consistent": t}
    valid = parents[:, 0] >= 0
    n_edges = valid.sum(dtype=torch.int32)
    n_components = _count_components(labels)
    # roots' (-1, -1) rows are vacuously fine: clamp the gather indices
    u = parents[:, 0].clamp(0, v - 1).long()
    w = parents[:, 1].clamp(0, v - 1).long()
    intra = torch.where(valid, labels[u] == labels[w], True).all()
    return {"n_forest_edges": n_edges,
            "n_roots": (v - n_edges).to(torch.int32),
            "n_components": n_components,
            "edges_intra_component": intra,
            "count_consistent": n_edges + n_components == v}


def _floor_log2(n: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2) of positive int32. frexp(x) = (m, e) with m in
    [0.5, 1) gives floor(log2 x) = e - 1 only while the cast to float32
    is exact (< 2^24): a component of 2^25 - 1 would round up and land a
    bin high. So the high half is shifted down first, and every value
    cast fits in 16 bits."""
    hi = n >> 16
    val = torch.where(hi > 0, hi, n).to(torch.float32)   # < 2^16: exact
    _, exp = torch.frexp(val)
    return exp - 1 + torch.where(hi > 0, 16, 0).to(exp.dtype)


def component_histogram(labels: torch.Tensor) -> torch.Tensor:
    """int32 [floor(log2 V) + 1]: ``hist[b]`` = the number of components
    of size in [2^b, 2^(b+1)). Census and exact log2 binning, on the
    device; the bins are counted from their sorted order (a scatter-add
    would put every non-representative id on one sentinel bin)."""
    labels = torch.as_tensor(labels)
    v = labels.shape[0]
    if v == 0:
        return torch.zeros((1,), dtype=torch.int32, device=labels.device)
    census = component_census(labels)
    nbins = max(int(v - 1).bit_length() + 1, 1)
    # empty census rows go to bin nbins, past the ones counted
    bins = torch.where(census > 0,
                       _floor_log2(torch.clamp(census, min=1)).long(), nbins)
    at = torch.searchsorted(torch.sort(bins).values,
                            torch.arange(nbins + 1, device=labels.device))
    return (at[1:] - at[:-1]).to(torch.int32)
