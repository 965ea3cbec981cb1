"""``repro_torch.obs`` — runtime telemetry for the port's front door:
host-side span tracing and always-on host counters (``obs.trace``),
with an opt-in bridge to ``torch.profiler.record_function``, and the
dynamic engine's on-device metric accumulators (``obs.metrics``). The
latency SLOs and the command line of ``repro.obs`` are not ported yet
(ROADMAP.md queue A, item A9)."""
from repro_torch.obs.trace import (EventLog, Span, Tracer,
                                   chrome_trace_events, count, disable,
                                   enable, enabled, span, span_summary,
                                   tracer)

__all__ = ["span", "count", "enable", "disable", "enabled", "tracer",
           "Tracer", "Span", "EventLog", "chrome_trace_events",
           "span_summary"]
