"""Seeded-bug fixtures — the analyzer's own regression suite, the torch
twins of ``repro.analysis.fixtures`` (same names, same ``EXPECTED`` /
``CLEAN`` tables, the port's codes).

Each fixture is a ``TraceEntry`` reproducing a *real* bug class from
this repo's history (or its known-good twin), kept OUT of the
production registry so the tree stays clean. ``--selftest`` (and
``tests/test_torch_analysis_passes.py``) run them through the full pass
stack and assert the analyzer still catches every one:

* ``fixture.int32_edge_key`` — edges keyed as ``min*V + max`` in int32.
  Exact until |V| ~ 46341, silent wraparound after; must flag at the
  scale bucket and stay quiet at the small bucket;
* ``fixture.int32_edge_key_fixed`` — the shipped fix (a lexicographic
  two-key sort, nothing packed); clean at every bucket;
* ``fixture.host_sync`` — a Python branch on a tensor inside a
  transfer-free program (the classic ``if count > 0:``): a
  ``__bool__`` read back;
* ``fixture.host_callback`` — a host round trip dressed up as a pure
  function, here a numpy round trip (``numpy()`` and back);
* ``fixture.unmasked_padded_sum`` — billing over a padded edge array
  with no dominating mask; its twin ``fixture.masked_padded_sum``
  applies the prefix mask and must be clean;
* ``fixture.retrace_nonpow2`` — a non-pow2 input shape plus a Python
  scalar on a bucketed entry;
* ``fixture.stale_forest_idx`` — summing edge spans gathered through
  ``parent_eidx`` log-row pointers that were not remapped through the
  log compaction's permutation: stale pointers land past the packed
  true count and bill retired rows; its twin
  ``fixture.stale_forest_idx_fixed`` remaps and masks by the
  post-compaction true count and must be clean.
"""
from __future__ import annotations

import torch

from repro_torch.api.registry import TraceEntry, VarInfo

_TF = frozenset({"transfer_free", "bucketed"})


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _build_edge_key(v, e):
    def fn(edges):
        u, w = edges[:, 0], edges[:, 1]
        lo = torch.minimum(u, w)
        hi = torch.maximum(u, w)
        key = lo * v + hi              # the packed key: wraps at scale
        return torch.sort(key).values
    return fn, (_meta((e, 2)),), [VarInfo(range=(0, v - 1))]


def _build_edge_key_fixed(v, e):
    def fn(edges):
        u, w = edges[:, 0], edges[:, 1]
        lo = torch.minimum(u, w)
        hi = torch.maximum(u, w)
        # the fix: two stable sorts, lexicographic, nothing packed
        order = torch.sort(hi, stable=True).indices
        order = order[torch.sort(lo[order], stable=True).indices]
        return lo[order], hi[order]
    return fn, (_meta((e, 2)),), [VarInfo(range=(0, v - 1))]


def _build_host_sync(v, e):
    def fn(edges):
        total = torch.sum(edges >= 0)
        if total > 0:                  # a Python branch on a tensor
            return total
        return torch.zeros((), dtype=torch.int64, device=edges.device)
    return fn, (_meta((e, 2)),), [VarInfo(range=(0, v - 1))]


def _build_host_callback(v, e):
    def fn(pi):
        # a host hop dressed up as a pure function
        return torch.from_numpy(pi.numpy().copy()).to(pi.device)
    return fn, (_meta((v,)),), [VarInfo(range=(0, v - 1))]


def _build_unmasked_sum(v, e):
    def fn(edges, true_edges):
        hops = edges[:, 0] - edges[:, 1]
        return torch.sum(torch.abs(hops))   # bills the padding rows
    return (fn, (_meta((e, 2)), _meta(())),
            [VarInfo(range=(0, v - 1), padded=True),
             VarInfo(range=(0, e), mask=True)])


def _build_masked_sum(v, e):
    def fn(edges, true_edges):
        hops = torch.abs(edges[:, 0] - edges[:, 1])
        alive = torch.arange(e, dtype=torch.int32,
                             device=edges.device) < true_edges
        return torch.sum(torch.where(alive, hops, 0))   # the discipline
    return (fn, (_meta((e, 2)), _meta(())),
            [VarInfo(range=(0, v - 1), padded=True),
             VarInfo(range=(0, e), mask=True)])


def _build_retrace_nonpow2(v, e):
    def fn(pi, shift):
        return pi + shift
    # a non-pow2 leading dim and a raw Python int in the signature
    return (fn, (_meta((e - 3,)), 7),
            [VarInfo(range=(0, v - 1)), VarInfo()])


def _build_stale_forest_idx(v, e):
    def fn(edges, parent_eidx, true_edges):
        # pre-compaction pointers into a freshly packed log: rows past
        # the true count are retired padding, but nothing masks them
        safe = torch.clamp(parent_eidx, min=0).long()
        rows = edges[safe]
        span = torch.abs(rows[:, 0] - rows[:, 1])
        return torch.sum(span)         # bills retired rows
    return (fn, (_meta((e, 2)), _meta((v,)), _meta(())),
            [VarInfo(range=(0, v - 1), padded=True),
             VarInfo(range=(-1, e - 1)),
             VarInfo(range=(0, e), mask=True)])


def _build_stale_forest_idx_fixed(v, e):
    def fn(edges, parent_eidx, perm, true_edges):
        # the fix: remap through the compaction permutation, then mask
        # by the post-compaction true count
        safe = torch.clamp(parent_eidx, min=0).long()
        idx = torch.where(parent_eidx >= 0, perm[safe], -1)
        rows = edges[torch.clamp(idx, min=0).long()]
        span = torch.abs(rows[:, 0] - rows[:, 1])
        live = (idx >= 0) & (idx < true_edges)
        return torch.sum(torch.where(live, span, 0))
    return (fn, (_meta((e, 2)), _meta((v,)), _meta((e,)), _meta(())),
            [VarInfo(range=(0, v - 1), padded=True),
             VarInfo(range=(-1, e - 1)),
             VarInfo(range=(-1, e - 1)),
             VarInfo(range=(0, e), mask=True)])


def fixture_entries() -> list:
    return [
        TraceEntry("fixture.int32_edge_key", _build_edge_key, _TF),
        TraceEntry("fixture.int32_edge_key_fixed", _build_edge_key_fixed,
                   _TF),
        TraceEntry("fixture.host_sync", _build_host_sync, _TF),
        TraceEntry("fixture.host_callback", _build_host_callback, _TF),
        TraceEntry("fixture.unmasked_padded_sum", _build_unmasked_sum,
                   _TF),
        TraceEntry("fixture.masked_padded_sum", _build_masked_sum, _TF),
        TraceEntry("fixture.retrace_nonpow2", _build_retrace_nonpow2,
                   _TF),
        TraceEntry("fixture.stale_forest_idx", _build_stale_forest_idx,
                   _TF),
        TraceEntry("fixture.stale_forest_idx_fixed",
                   _build_stale_forest_idx_fixed, _TF),
    ]


# entry -> (pass_id, finding code, bucket it must fire at) — "scale"
# means the small bucket must stay QUIET (that asymmetry is the point)
EXPECTED = {
    "fixture.int32_edge_key": ("int32", "mul-overflow", "scale"),
    "fixture.host_sync": ("transfer", "host-read-__bool__", "any"),
    "fixture.host_callback": ("transfer", "host-read-numpy", "any"),
    "fixture.unmasked_padded_sum": ("padmask", "unmasked-padded-sum",
                                    "any"),
    "fixture.retrace_nonpow2": ("retrace", "non-pow2-shape-arg0", "any"),
    "fixture.stale_forest_idx": ("padmask", "unmasked-padded-sum", "any"),
}

# entries that must produce ZERO findings (the fixed twins)
CLEAN = {"fixture.int32_edge_key_fixed", "fixture.masked_padded_sum",
         "fixture.stale_forest_idx_fixed"}
