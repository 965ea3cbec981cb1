"""repro_torch.obs.trace against repro.obs.trace: the ring buffer, the
disabled fast path, span records and tags, the always-on counters, the
two exporters and the summary equal to the reference's on the same
events, and the torch.profiler bridge."""
import json

import pytest
import torch

from repro.obs import trace as jtrace
from repro_torch.obs import trace as ttrace


@pytest.mark.parametrize("capacity,n", [(1, 0), (1, 3), (4, 4), (4, 11)])
def test_event_log_matches_reference(capacity, n):
    got, want = ttrace.EventLog(capacity), jtrace.EventLog(capacity)
    for i in range(n):
        got.append({"i": i})
        want.append({"i": i})
    assert got.events() == want.events()
    assert (len(got), got.total, got.dropped) == \
        (len(want), want.total, want.dropped)
    got.clear()
    assert got.events() == [] and got.total == 0
    with pytest.raises(ValueError):
        ttrace.EventLog(0)


def test_spans_counters_and_exports(tmp_path):
    tracer = ttrace.tracer()
    tracer.reset()
    assert not ttrace.enabled()
    assert ttrace.span("off") is ttrace.span("other")   # shared no-op
    with ttrace.span("off") as sp:
        sp.tag(x=1)
    assert len(tracer.log) == 0
    ttrace.count("hits")
    ttrace.count("hits", 2)
    ttrace.enable(capacity=8)
    try:
        with ttrace.span("outer", tenant="a", step=3, k=1):
            with ttrace.span("inner") as sp:
                sp.tag(route="sampled")
        with pytest.raises(KeyError):
            with ttrace.span("failing"):
                raise KeyError("x")
    finally:
        ttrace.disable()
    events = tracer.log.events()
    assert [e["name"] for e in events] == ["inner", "outer", "failing"]
    assert events[0]["depth"] == 1 and events[1]["depth"] == 0
    assert events[0]["tags"] == {"route": "sampled"}
    assert events[1]["tenant"] == "a" and events[1]["step"] == 3
    assert events[2]["error"] == "KeyError"
    assert tracer.counters == {"hits": 3}
    assert ttrace.chrome_trace_events(events) == \
        jtrace.chrome_trace_events(events)
    assert ttrace.span_summary(events) == jtrace.span_summary(events)
    assert tracer.summary() == jtrace.span_summary(events)
    tracer.export_jsonl(str(tmp_path / "t.jsonl"))
    lines = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert [x["type"] for x in lines] == ["span"] * 3 + ["counters"]
    assert lines[-1]["counters"] == {"hits": 3}
    tracer.export_chrome_trace(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json")) == \
        jtrace.chrome_trace_events(events)
    tracer.reset()
    assert len(tracer.log) == 0 and tracer.counters == {}


def test_torch_annotations_open_record_function_ranges():
    from torch.profiler import ProfilerActivity, profile
    tracer = ttrace.tracer()
    tracer.reset()
    ttrace.enable(torch_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttrace.span("front.solve"):
                torch.arange(8).sum()
            with ttrace.span("front.tick", step=2):
                torch.arange(8).sum()
    finally:
        ttrace.disable()
        tracer.reset()
    names = {e.name for e in prof.events()}
    assert {"front.solve", "front.tick step 2"} <= names
    assert not tracer._annotate
