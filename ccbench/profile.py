"""The reduction of a ``torch.profiler`` trace to the device numbers a
traced run reports: the seconds in which a device operation ran inside
the traced window (the union of kernel, copy and set intervals), the
window's length, the device operations that took most time, and the
idle gaps summed by what the host was doing when the device ran dry.

The traced window is the profiler range named ``WINDOW`` that the
harness opens around the traced iterations, after a synchronise, and
closes after another; the host and device events of one trace share its
clock. The device rows the profiler makes of the harness's own ranges
(user annotations) are left out: they are no device operation.
"""
from __future__ import annotations

import bisect

WINDOW = "ccbench.traced_window"
SPAN_PREFIX = "ccbench."


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_label(spans: list, cpu: list, starts: list, t: float) -> str:
    """``<benchmark span>:<innermost host op>`` running at time ``t``."""
    outer = "outside"
    for name, s, e in spans:
        if s <= t <= e:
            outer = name.removeprefix(SPAN_PREFIX)
    inner = "python"
    i = bisect.bisect_right(starts, t) - 1
    # the latest-starting event that still covers t is the innermost one
    for j in range(i, max(i - 4000, -1), -1):
        name, s, e = cpu[j]
        if e >= t:
            inner = name
            break
    return f"{outer}:{inner}"


def reduce(prof, top: int = 10) -> dict:
    """``{"busy_s", "window_s", "device_ops", "idle_gaps"}`` of a
    finished profile; ``busy_s`` is 0 when the trace holds no device
    event (the profiler can lose a session's device events)."""
    from torch.autograd import DeviceType
    window, spans, cpu, dev = None, [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == DeviceType.CPU:
            if ev.name == WINDOW:
                window = (s, e)
            elif ev.name.startswith(SPAN_PREFIX):
                spans.append((ev.name, s, e))
            else:
                cpu.append((ev.name, s, e))
        elif e > s and not ev.name.startswith(SPAN_PREFIX):
            # the device rows of the harness's own ranges (user
            # annotations) are not operations
            dev.append((ev.name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
              if e > w0 and s < w1]
    merged = _merge([(s, e) for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    ops: dict = {}
    for name, s, e in inside:
        ops[name] = ops.get(name, 0.0) + (e - s)
    cpu.sort(key=lambda r: r[1])
    starts = [r[1] for r in cpu]
    gaps: dict = {}
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            label = _host_label(spans, cpu, starts, (edge + s) / 2)
            gaps[label] = gaps.get(label, 0.0) + (s - edge)
        edge = max(edge, e)
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": w1 - w0,
            "device_ops": [[k[:120], v] for k, v in by_time(ops)],
            "idle_gaps": [[k[:120], v] for k, v in by_time(gaps)]}
