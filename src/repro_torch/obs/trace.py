"""Host-side span tracer of ``repro.obs.trace``, for the port.

The runtime twin of ``ExecutionPlan.explain()``: what actually ran, span
by span, with the plan's provenance (backend, shape bucket, forced /
autotune / heuristic) and the tenant attached to every event.

1. **Disabled mode is (nearly) free.** ``span(...)`` checks one
   module-level flag and returns a shared stateless null context manager:
   no allocation, no clock read.
2. **Bounded memory.** Finished spans land in a fixed-capacity ring
   buffer (``EventLog``); the oldest events are overwritten and
   ``dropped`` says how many fell off.
3. **Standard library only.** The optional bridge to
   ``torch.profiler.record_function`` (``enable(torch_annotations=True)``)
   makes every span a named range of a profiler trace, so device time
   lines up with host spans when a profiler session is active.

Host **counters** (``count(name)``) are always on: plain dict increments
for process-wide facts that must not depend on when ``enable()`` was
called (autotune cache hits and misses, the sampled engine's work
split, and the engines' device-to-host reads: ``read(site, fn)`` counts
one under ``read.<site>`` and, while tracing is on, the nanoseconds the
host waited under ``read_ns.<site>``).

Span starts (``ts_us``) are on the wall clock (``time.time_ns``), the
clock ``torch.profiler`` stamps its host events with, so an exported
trace lines up with a profiler trace of the same run; durations are
taken on ``time.perf_counter_ns``. ``PORT_ONLY`` lists the span and
counter names that only the port's eager loops have.

Exports: ``export_jsonl`` writes one JSON object per span plus a
trailing ``counters`` record; ``export_chrome_trace`` writes the Chrome
``trace_event`` format (complete "X" events, microseconds), which
Perfetto and chrome://tracing load.
"""
from __future__ import annotations

import json
import time
from typing import Optional

_ENABLED = False        # THE module-level fast-path flag (see enable())

# prefixes of the names that the reference has no counterpart of: its
# loops run on the device inside one program, so it reads nothing back
# and has no phase spans inside a solve or a delete
PORT_ONLY = ("read.", "read_ns.", "solver.open", "solver.plan", "cc.",
             "dyn.")


class _NullSpan:
    """Shared stateless no-op span — what ``span()`` returns while
    tracing is disabled. One instance serves every call site."""

    __slots__ = ()
    enabled = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def tag(self, **tags) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class EventLog:
    """Fixed-capacity ring buffer of finished-span records.

    ``append`` is O(1) and never allocates past ``capacity``; once
    full, the oldest event is overwritten (``dropped`` counts how many
    fell off). ``events()`` returns the retained records oldest-first.
    """

    __slots__ = ("capacity", "_buf", "_n")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self._buf: list = [None] * capacity
        self._n = 0

    def append(self, event: dict) -> None:
        self._buf[self._n % self.capacity] = event
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        """Events ever appended (retained + dropped)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by wraparound."""
        return max(0, self._n - self.capacity)

    def events(self) -> list:
        """Retained events, oldest first (wraparound-corrected)."""
        if self._n <= self.capacity:
            return list(self._buf[: self._n])
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0


class Span:
    """One live span. Use via ``with span("name", tenant=..., **tags)``;
    ``tag(...)`` attaches facts learned mid-span (the policy route, the
    retired-request count) before it closes."""

    __slots__ = ("name", "tenant", "step", "tags", "depth",
                 "_tracer", "_t0_ns", "_wall_ns", "_annotation")
    enabled = True

    def __init__(self, tracer: "Tracer", name: str,
                 tenant: Optional[str], step: Optional[int],
                 tags: dict):
        self.name = name
        self.tenant = tenant
        self.step = step
        self.tags = tags
        self.depth = 0
        self._tracer = tracer
        self._t0_ns = 0
        self._wall_ns = 0
        self._annotation = None

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        t = self._tracer
        self.depth = len(t._stack)
        t._stack.append(self)
        ann = t._annotation_for(self.name, self.step)
        if ann is not None:
            ann.__enter__()
            self._annotation = ann
        self._wall_ns = time.time_ns()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0_ns
        t = self._tracer
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        if t._stack and t._stack[-1] is self:
            t._stack.pop()
        rec = {"name": self.name,
               "ts_us": round(self._wall_ns / 1e3, 3),
               "dur_us": round(dur_ns / 1e3, 3),
               "depth": self.depth}
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        if self.step is not None:
            rec["step"] = self.step
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.tags:
            rec["tags"] = self.tags
        t.log.append(rec)
        return False


class Tracer:
    """Span factory + event log + host counters for one process."""

    def __init__(self, capacity: int = 4096):
        self.log = EventLog(capacity)
        self.counters: dict[str, int] = {}
        self._stack: list = []
        self._annotate = False
        self._record_function = None       # torch.profiler, lazy

    # -- span / counter entry points ----------------------------------------

    def span(self, name: str, tenant: Optional[str] = None,
             step: Optional[int] = None, **tags) -> Span:
        return Span(self, name, tenant, step, tags)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _annotation_for(self, name: str, step: Optional[int]):
        """The torch.profiler bridge: host spans double as
        ``record_function`` ranges when opted in, so a profiler trace
        shows them around the device work they launched. A ``step``
        span's range carries its step number in its name."""
        if not self._annotate:
            return None
        return self._record_function(
            name if step is None else f"{name} step {step}")

    def enable_torch_annotations(self) -> None:
        from torch.profiler import record_function
        self._record_function = record_function
        self._annotate = True

    def reset(self) -> None:
        """Forget events, counters, and the open-span stack
        (test/benchmark hook)."""
        self.log.clear()
        self.counters.clear()
        self._stack.clear()

    # -- exporters ----------------------------------------------------------

    def export_jsonl(self, path: str) -> None:
        """JSON-lines: one ``{"type": "span", ...}`` object per event,
        plus one trailing ``{"type": "counters", ...}`` record carrying
        the host counters and the ring-buffer drop count."""
        with open(path, "w") as fh:
            for ev in self.log.events():
                fh.write(json.dumps({"type": "span", **ev}) + "\n")
            fh.write(json.dumps({"type": "counters",
                                 "counters": dict(self.counters),
                                 "dropped": self.log.dropped,
                                 "total_spans": self.log.total}) + "\n")

    def export_chrome_trace(self, path: str) -> None:
        """Chrome ``trace_event`` JSON (Perfetto-loadable): complete
        "X" events on one thread track — nesting comes from ts/dur
        containment, tags ride in ``args``."""
        with open(path, "w") as fh:
            json.dump(chrome_trace_events(self.log.events()), fh)

    def summary(self) -> dict:
        """Per-span-name aggregates over the retained events:
        ``{name: {count, total_ms, p50_us, p99_us}}`` (percentiles are
        exact over the retained window — the ring buffer bounds it)."""
        return span_summary(self.log.events())


# ---------------------------------------------------------------------------
# Pure helpers shared with the CLI (which reads exported JSONL files)
# ---------------------------------------------------------------------------

def chrome_trace_events(events: list) -> dict:
    out = []
    for ev in events:
        args = dict(ev.get("tags", {}))
        if ev.get("tenant") is not None:
            args["tenant"] = ev["tenant"]
        if ev.get("step") is not None:
            args["step"] = ev["step"]
        out.append({"ph": "X", "name": ev["name"],
                    "cat": ev.get("tenant") or "repro",
                    "ts": ev["ts_us"], "dur": ev["dur_us"],
                    "pid": 0, "tid": 0, "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def span_summary(events: list) -> dict:
    by_name: dict[str, list] = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev["dur_us"])
    out = {}
    for name in sorted(by_name):
        durs = sorted(by_name[name])
        n = len(durs)
        pct = lambda q: durs[min(n - 1, int(q * (n - 1) + 0.5))]  # noqa: E731
        out[name] = {"count": n,
                     "total_ms": round(sum(durs) / 1e3, 3),
                     "p50_us": round(pct(0.50), 1),
                     "p99_us": round(pct(0.99), 1)}
    return out


# ---------------------------------------------------------------------------
# The module-level API (what every instrumented site calls)
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


def enabled() -> bool:
    return _ENABLED


def enable(*, capacity: int | None = None,
           torch_annotations: bool = False) -> Tracer:
    """Turn span tracing on. ``capacity`` resizes the ring buffer
    (clearing it); ``torch_annotations=True`` also opens a
    ``torch.profiler.record_function`` range for every span, so device
    profiles line up with host spans. Host counters are unaffected
    (always on)."""
    global _ENABLED
    if capacity is not None and capacity != _TRACER.log.capacity:
        _TRACER.log = EventLog(capacity)
    if torch_annotations:
        _TRACER.enable_torch_annotations()
    _ENABLED = True
    return _TRACER


def disable() -> None:
    """Turn span tracing off (the default). Already-recorded events and
    counters are kept — export or ``tracer().reset()`` as needed."""
    global _ENABLED
    _ENABLED = False
    _TRACER._annotate = False


def span(name: str, tenant: Optional[str] = None,
         step: Optional[int] = None, **tags):
    """A span context manager — or the shared no-op when disabled.

    The disabled path is one global flag check and the return of a
    shared stateless object."""
    if not _ENABLED:
        return _NULL_SPAN
    return _TRACER.span(name, tenant, step, **tags)


def count(name: str, n: int = 1) -> None:
    """Bump a host counter (always on — independent of ``enable()``)."""
    _TRACER.count(name, n)


def read(site: str, fn):
    """Return ``fn()``, a device-to-host read (``bool``, ``int``,
    ``.item()``, ``.tolist()``, ``.cpu()``, or a ``nonzero`` whose size
    the host uses), counted under ``read.<site>`` (always on); while
    tracing is on, the nanoseconds it blocked the host are added to
    ``read_ns.<site>``. ``fn`` is a lambda written at the call site, so
    the read stays in the caller's frame, where the analysis passes
    place it."""
    _TRACER.count("read." + site)
    if not _ENABLED:
        return fn()
    t0 = time.perf_counter_ns()
    out = fn()
    _TRACER.count("read_ns." + site, time.perf_counter_ns() - t0)
    return out
