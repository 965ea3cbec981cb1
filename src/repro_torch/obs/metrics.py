"""On-device metric accumulators of ``repro.obs.metrics``, for the port.

A small ``Metrics`` tuple (named int32 counters plus fixed-size int32
histogram bucket arrays) carried beside the dynamic engine's state like
``core.rounds.WorkCounters``: updated by device ops on every mutation,
merged by elementwise addition, and read on the host only at an
explicit ``flush()`` through ``connectivity.queries.to_host``.

* every field is a fixed-shape int32 tensor; named slots index into a
  padded array (16 counter slots, 4 x 32 histogram buckets);
* updates are ``(Metrics, device scalars) -> Metrics`` functions with no
  host branch on device values;
* ``merge`` is elementwise ``+``, so accumulators fold in any order;
* counters are int32 adds: flush well before 2^31 events.

``HistogramSpec`` is the reference's log-spaced bucket layout: a
quantile read off bucket counts is exact to within one bucket.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HistogramSpec:
    """Fixed log-spaced bucket layout shared by device and host
    accumulators.

    ``num_bins`` buckets over ``num_bins - 1`` inner edges (geometrically
    spaced from ``lo`` to ``hi``): bucket 0 is the underflow ``(-inf,
    lo)``, bucket ``num_bins - 1`` the overflow ``[hi, inf)``. A quantile
    estimated from bucket counts is the geometric midpoint of the
    crossing bucket, off by at most one edge ratio (``resolution()``).
    """

    lo: float
    hi: float
    num_bins: int

    def __post_init__(self):
        if not (0 < self.lo < self.hi):
            raise ValueError(f"need 0 < lo < hi, got {self.lo}, {self.hi}")
        if self.num_bins < 4:
            raise ValueError(f"need >= 4 bins, got {self.num_bins}")

    @functools.cached_property
    def edges(self) -> np.ndarray:
        """Inner edges, float64 [num_bins - 1], log-spaced lo..hi."""
        return np.geomspace(self.lo, self.hi, self.num_bins - 1)

    def resolution(self) -> float:
        """Adjacent-edge ratio: the worst-case multiplicative error of
        ``quantile`` against the true sample quantile."""
        return float((self.hi / self.lo) ** (1.0 / (self.num_bins - 2)))

    def bucket(self, values) -> np.ndarray:
        """Host bucket index/indices for value(s)."""
        return np.searchsorted(self.edges, values, side="right")

    def bucket_device(self, values: torch.Tensor) -> torch.Tensor:
        """Device bucket indices (int64) of a value tensor, bucketed in
        float32 as the reference does."""
        return torch.searchsorted(_on(values.device, "edges", lambda: (
            torch.as_tensor(self.edges, dtype=torch.float32))),
            values.to(torch.float32), right=True)

    def observe(self, counts: np.ndarray, value: float) -> None:
        """Host in-place increment."""
        counts[int(np.searchsorted(self.edges, value, side="right"))] += 1

    def quantile(self, counts: np.ndarray, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from bucket counts: the
        geometric midpoint of the bucket where the cumulative count
        crosses ``q * total`` (underflow reads as ``lo``, overflow as
        ``hi``). NaN when empty."""
        counts = np.asarray(counts)
        total = int(counts.sum())
        if total == 0:
            return float("nan")
        rank = max(q * total, 1e-9)
        b = int(np.searchsorted(np.cumsum(counts), rank, side="left"))
        if b <= 0:
            return float(self.lo)
        if b >= self.num_bins - 1:
            return float(self.hi)
        return float(np.sqrt(self.edges[b - 1] * self.edges[b]))


# batch sizes and per-batch hook work span 1 .. ~1e9 over 32 bins
WORK_SPEC = HistogramSpec(lo=1.0, hi=2.0**30, num_bins=32)

# named counter slots, padded to _NUM_SLOTS
COUNTERS = (
    "absorbs",          # incremental-path insert batches
    "deletes",          # scoped-delete batches
    "rebuilds",         # mutations routed through a static engine
    "merges",           # absorbs that changed the partition (version tick)
    "splits",           # deletes that changed the partition (version tick)
    "edges_absorbed",   # true (unpadded) rows across absorb batches
    "edges_retired",    # true (unpadded) rows across delete batches
    "hook_ops",         # per-batch hook work folded from WorkCounters
    "jump_sweeps",      # pointer-jumping sweeps folded from WorkCounters
)
_NUM_SLOTS = 16
assert len(COUNTERS) <= _NUM_SLOTS

HIST_KINDS = (
    "absorb_edges",     # true batch size per absorb
    "delete_edges",     # true batch size per delete
    "absorb_hook_ops",  # hook work per absorb batch
    "delete_hook_ops",  # hook work per delete batch
)

_C = {name: i for i, name in enumerate(COUNTERS)}
_H = {name: i for i, name in enumerate(HIST_KINDS)}

_CONSTANTS: dict = {}


def _on(device, name: str, make) -> torch.Tensor:
    """A constant tensor made once per device (so a tick copies nothing
    from the host)."""
    key = (str(device), name)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = make().to(device)
    return _CONSTANTS[key]


class Metrics(NamedTuple):
    """``counts`` int32 [16] (named slots via ``COUNTERS``), ``hist``
    int32 [4, 32] (``HIST_KINDS`` x ``WORK_SPEC`` buckets)."""

    counts: torch.Tensor
    hist: torch.Tensor

    @staticmethod
    def zeros(device=None) -> "Metrics":
        return Metrics(
            counts=torch.zeros((_NUM_SLOTS,), dtype=torch.int32,
                               device=device),
            hist=torch.zeros((len(HIST_KINDS), WORK_SPEC.num_bins),
                             dtype=torch.int32, device=device))

    def merge(self, other: "Metrics") -> "Metrics":
        """Elementwise sum: associative and commutative."""
        return Metrics(self.counts + other.counts, self.hist + other.hist)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def record_mutation(metrics: Metrics, batch_work, true_count,
                    version_before, version_after, *, kind: str) -> Metrics:
    """Fold one mutation batch into the accumulators. Every operand is a
    device scalar (or the batch's ``WorkCounters``), so this adds device
    ops to the tick and reads nothing back. ``kind`` is "insert" or
    "delete"; the partition-change bit is ``version_after !=
    version_before``, computed on the device."""
    if kind == "insert":
        tick, edge_slot, change_slot = "absorbs", "edges_absorbed", "merges"
        h_edges, h_hook = "absorb_edges", "absorb_hook_ops"
    elif kind == "delete":
        tick, edge_slot, change_slot = "deletes", "edges_retired", "splits"
        h_edges, h_hook = "delete_edges", "delete_hook_ops"
    else:
        raise ValueError(f"kind must be insert|delete, got {kind!r}")
    dev = metrics.counts.device
    true_count = _i32(true_count, dev)
    hook_ops = _i32(batch_work.hook_ops, dev)
    changed = (_i32(version_after, dev)
               != _i32(version_before, dev)).to(torch.int32)
    slots = _on(dev, kind + ".slots", lambda: torch.tensor(
        [_C[tick], _C[edge_slot], _C[change_slot], _C["hook_ops"],
         _C["jump_sweeps"]]))
    amounts = torch.stack([torch.ones((), dtype=torch.int32, device=dev),
                           true_count, changed, hook_ops,
                           _i32(batch_work.jump_sweeps, dev)])
    counts = metrics.counts.index_add(0, slots, amounts)
    rows = _on(dev, kind + ".rows", lambda: torch.tensor(
        [_H[h_edges], _H[h_hook]]))
    buckets = WORK_SPEC.bucket_device(torch.stack([true_count, hook_ops]))
    hist = metrics.hist.index_put((rows, buckets),
                                  torch.ones_like(rows, dtype=torch.int32),
                                  accumulate=True)
    return Metrics(counts, hist)


def record_rebuild(metrics: Metrics) -> Metrics:
    """Count a static-rebuild adoption. Rebuild work is billed through
    the engine's own ``WorkCounters``; the accumulator counts the
    route."""
    one = _on(metrics.counts.device, "rebuild", lambda: torch.eye(
        _NUM_SLOTS, dtype=torch.int32)[_C["rebuilds"]])
    return Metrics(metrics.counts + one, metrics.hist)


def flush(metrics: Metrics) -> dict:
    """Materialize the accumulators on the host (the one device-to-host
    crossing, through ``queries.to_host``). Returns ``{"counters":
    {name: int}, "histograms": {kind: {count, p50, p99}}}``."""
    from repro_torch.connectivity.queries import to_host
    counts = to_host(metrics.counts)
    hist = to_host(metrics.hist)
    out = {"counters": {name: int(counts[i]) for name, i in _C.items()},
           "histograms": {}}
    for kind, row in _H.items():
        c = np.asarray(hist[row], np.int64)
        n = int(c.sum())
        entry = {"count": n}
        if n:
            entry["p50"] = round(WORK_SPEC.quantile(c, 0.50), 3)
            entry["p99"] = round(WORK_SPEC.quantile(c, 0.99), 3)
        out["histograms"][kind] = entry
    return out
