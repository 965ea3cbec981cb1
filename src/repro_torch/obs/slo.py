"""Latency SLO histograms of ``repro.obs.slo``, for the port: per-tenant
and global p50/p90/p99 for service requests.

Host-side by construction — request latency is a wall-clock fact that
only exists on the host — but built on the SAME fixed log-bucket
layout as the device accumulators (``metrics.HistogramSpec``), so the
quantile math, its one-bucket error bound, and the associative-merge
property are shared and tested once. Recording is an O(log bins)
``searchsorted`` + one int add per request; a recorder never grows
past ``tenants x kinds x num_bins`` int64 cells no matter how many
requests it sees.

Global percentiles are computed by MERGING the per-(tenant, kind)
bucket counts — exact (bucket merge is associative), not an average
of percentiles (which would be wrong).
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import HistogramSpec

# 1µs .. 10s over 64 bins: ~1.3x per bucket across 7 decades — finer
# than any SLO threshold anyone sets, coarse enough to stay tiny.
DEFAULT_LATENCY_SPEC = HistogramSpec(lo=1e-6, hi=10.0, num_bins=64)

_PERCENTILES = (0.50, 0.90, 0.99)


class LatencyHistogram:
    """Bucket counts for one (tenant, kind) stream."""

    __slots__ = ("spec", "counts")

    def __init__(self, spec: HistogramSpec = DEFAULT_LATENCY_SPEC):
        self.spec = spec
        self.counts = np.zeros(spec.num_bins, np.int64)

    def record(self, seconds: float) -> None:
        self.spec.observe(self.counts, seconds)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if other.spec != self.spec:
            raise ValueError("cannot merge histograms with different specs")
        out = LatencyHistogram(self.spec)
        out.counts = self.counts + other.counts
        return out

    def quantile(self, q: float) -> float:
        """q in [0, 1]; seconds; NaN when empty."""
        return self.spec.quantile(self.counts, q)


class SLORecorder:
    """Per-(tenant, kind) latency histograms + exact merged reads.

    ``kind`` is the service request kind ("insert", "delete",
    "same_component", ...). ``percentile(q, tenant=..., kinds=...)``
    merges every matching histogram before reading — pass
    ``tenant=None`` for the global view.
    """

    def __init__(self, spec: HistogramSpec = DEFAULT_LATENCY_SPEC):
        self.spec = spec
        self._hists: dict[tuple[str, str], LatencyHistogram] = {}

    def record(self, tenant: str, kind: str, seconds: float) -> None:
        key = (tenant, kind)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = LatencyHistogram(self.spec)
        h.record(seconds)

    def hist(self, tenant: str, kind: str) -> LatencyHistogram | None:
        return self._hists.get((tenant, kind))

    def tenants(self) -> list[str]:
        return sorted({t for t, _ in self._hists})

    def kinds(self, tenant: str | None = None) -> list[str]:
        return sorted({k for t, k in self._hists
                       if tenant is None or t == tenant})

    def merged(self, tenant: str | None = None,
               kinds=None) -> LatencyHistogram:
        """One histogram over every matching (tenant, kind) stream.

        Bucket-edge compatibility is asserted per stream: summing raw
        ``counts`` across histograms is only exact when every stream
        shares the recorder's bucket layout, and a recorder whose
        ``_hists`` were populated externally (the fleet's per-device
        merge path) could otherwise silently mix layouts — the merged
        percentiles would read from the wrong edges."""
        out = LatencyHistogram(self.spec)
        for (t, k), h in self._hists.items():
            if tenant is not None and t != tenant:
                continue
            if kinds is not None and k not in kinds:
                continue
            if h.spec != self.spec:
                raise ValueError(
                    f"histogram for {(t, k)!r} has spec {h.spec}, "
                    f"recorder has {self.spec}: bucket counts are not "
                    "mergeable across different edge layouts")
            out.counts += h.counts
        return out

    def percentile(self, q: float, tenant: str | None = None,
                   kinds=None) -> float:
        """q in [0, 1]; seconds; NaN when nothing matched."""
        return self.merged(tenant, kinds).quantile(q)

    def summary(self) -> dict:
        """``{"global": {kind: {...}}, "tenants": {tenant: {kind:
        {count, p50_ms, p90_ms, p99_ms}}}}`` — milliseconds, exact
        merged global rows."""

        def row(h: LatencyHistogram) -> dict:
            out = {"count": h.count}
            for q in _PERCENTILES:
                out[f"p{int(q * 100)}_ms"] = round(h.quantile(q) * 1e3, 4)
            return out

        tenants: dict[str, dict] = {}
        for (t, k), h in sorted(self._hists.items()):
            tenants.setdefault(t, {})[k] = row(h)
        return {"global": {k: row(self.merged(kinds=(k,)))
                           for k in self.kinds()},
                "tenants": tenants}


def merge_recorders(recorders) -> SLORecorder:
    """Fold several recorders into one — the fleet's global view over
    per-device ``SLORecorder``s. Exact by the same argument as
    ``merged()``: bucket counts add associatively, so the global
    percentiles equal those of one recorder that saw every request.
    Edge compatibility is asserted across ALL inputs (recorder specs
    and each per-stream histogram) before any counts are summed."""
    recorders = list(recorders)
    spec = recorders[0].spec if recorders else DEFAULT_LATENCY_SPEC
    out = SLORecorder(spec)
    for rec in recorders:
        if rec.spec != spec:
            raise ValueError(
                f"cannot merge recorders with specs {rec.spec} != {spec}"
                ": bucket counts are not mergeable across different "
                "edge layouts")
        for (t, k), h in rec._hists.items():
            if h.spec != spec:
                raise ValueError(
                    f"histogram for {(t, k)!r} has spec {h.spec}, "
                    f"merge target has {spec}")
            tgt = out._hists.get((t, k))
            if tgt is None:
                tgt = out._hists[(t, k)] = LatencyHistogram(spec)
            tgt.counts = tgt.counts + h.counts
    return out
