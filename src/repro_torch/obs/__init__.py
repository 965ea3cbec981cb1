"""``repro_torch.obs`` — runtime telemetry for the port's front door and
the connectivity service (``repro.obs``), in three opt-in, bounded
layers:

* **Span tracing** (``obs.trace``): host-side ``span(...)`` context
  managers around facade and service operations and the engines'
  phases, tagged with plan provenance and tenant; a fixed-capacity ring
  buffer of finished spans; JSON-lines and Chrome ``trace_event``
  (Perfetto) exporters; an opt-in bridge to
  ``torch.profiler.record_function``. Disabled (the default) it costs
  one flag check per call site; the engines' device-to-host reads are
  counted even then (``read(site, fn)``).
* **On-device metrics** (``obs.metrics``): a ``Metrics`` tuple of int32
  counters and fixed-bucket histograms carried through the dynamic
  engine's mutations like ``WorkCounters``, read on the host only at
  ``metrics.flush()``.
* **Latency SLOs** (``obs.slo``): per-tenant and global p50/p90/p99
  request-latency histograms on the shared ``HistogramSpec`` buckets.

``python -m repro_torch.obs summary <trace.jsonl>`` renders a trace;
``python -m repro_torch.obs perfetto <trace.jsonl> <out.json>`` converts
one for the Perfetto UI.
"""
from repro_torch.obs.metrics import (COUNTERS, HIST_KINDS, WORK_SPEC,
                                     HistogramSpec, Metrics, flush,
                                     record_mutation, record_rebuild)
from repro_torch.obs.slo import (DEFAULT_LATENCY_SPEC, LatencyHistogram,
                                 SLORecorder, merge_recorders)
from repro_torch.obs.trace import (PORT_ONLY, EventLog, Span, Tracer,
                                   chrome_trace_events, count, disable,
                                   enable, enabled, read, span,
                                   span_summary, tracer)

__all__ = [
    # trace
    "span", "count", "read", "enable", "disable", "enabled", "tracer",
    "PORT_ONLY",
    "Tracer", "Span", "EventLog", "chrome_trace_events", "span_summary",
    # metrics
    "Metrics", "HistogramSpec", "WORK_SPEC", "COUNTERS", "HIST_KINDS",
    "record_mutation", "record_rebuild", "flush",
    # slo
    "SLORecorder", "LatencyHistogram", "DEFAULT_LATENCY_SPEC",
    "merge_recorders",
]
