"""repro_torch.obs.slo against repro.obs.slo: fixed latencies recorded
into both give equal bucket counts, quantiles, merged views and
``summary()``; ``merge_recorders`` and its refusals; and the ``obs``
command line of both packages prints the same on a trace the port
exported. Pure host arithmetic: the tolerance is 0."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.obs import metrics as jmetrics, slo as jslo
from repro_torch import obs as tobs
from repro_torch.obs import metrics as tmetrics, slo as tslo

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("insert", "same_component", "count_components")


def _latencies(seed: int, n: int) -> list:
    """(tenant, kind, seconds) rows spanning the spec's under- and
    overflow buckets."""
    rng = np.random.default_rng(seed)
    secs = np.exp(rng.uniform(np.log(1e-7), np.log(30.0), n))
    return [(f"t{int(rng.integers(0, 3))}", KINDS[int(rng.integers(0, 3))],
             float(s)) for s in secs]


def _both(rows, spec_args=None):
    if spec_args is None:
        j, t = jslo.SLORecorder(), tslo.SLORecorder()
    else:
        j = jslo.SLORecorder(jmetrics.HistogramSpec(*spec_args))
        t = tslo.SLORecorder(tmetrics.HistogramSpec(*spec_args))
    for tenant, kind, s in rows:
        j.record(tenant, kind, s)
        t.record(tenant, kind, s)
    return j, t


def _same(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


@pytest.mark.parametrize("seed,n,spec_args", [
    (0, 1, None), (1, 50, None), (2, 2000, None), (3, 300, (1e-4, 1.0, 8))])
def test_recorder_matches_reference(seed, n, spec_args):
    j, t = _both(_latencies(seed, n), spec_args)
    assert t.summary() == j.summary()
    assert t.tenants() == j.tenants()
    for tenant in [None] + j.tenants():
        assert t.kinds(tenant) == j.kinds(tenant)
        for kinds in (None, KINDS[:1], KINDS[1:]):
            for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
                assert _same(t.percentile(q, tenant, kinds),
                             j.percentile(q, tenant, kinds))
            np.testing.assert_array_equal(t.merged(tenant, kinds).counts,
                                          j.merged(tenant, kinds).counts)
    for tenant in j.tenants():
        for kind in KINDS:
            jh, th = j.hist(tenant, kind), t.hist(tenant, kind)
            assert (jh is None) == (th is None)
            if jh is not None:
                assert th.count == jh.count
                np.testing.assert_array_equal(th.counts, jh.counts)


def test_empty_histogram_and_merge_refusals():
    assert math.isnan(tslo.LatencyHistogram().quantile(0.5))
    assert math.isnan(tslo.SLORecorder().percentile(0.99))
    assert tslo.SLORecorder().summary() == jslo.SLORecorder().summary()
    other = tslo.LatencyHistogram(tmetrics.HistogramSpec(1e-3, 1.0, 8))
    with pytest.raises(ValueError, match="different specs"):
        tslo.LatencyHistogram().merge(other)
    a = tslo.SLORecorder()
    b = tslo.SLORecorder(tmetrics.HistogramSpec(1e-3, 1.0, 8))
    with pytest.raises(ValueError, match="not mergeable"):
        tslo.merge_recorders([a, b])
    assert tslo.DEFAULT_LATENCY_SPEC == tmetrics.HistogramSpec(
        lo=1e-6, hi=10.0, num_bins=64)


@pytest.mark.parametrize("parts", [1, 3])
def test_merge_recorders_matches_reference(parts):
    rows = _latencies(9, 600)
    chunks = [rows[i::parts] for i in range(parts)]
    js, ts = zip(*(_both(c) for c in chunks))
    got, want = tslo.merge_recorders(ts), jslo.merge_recorders(js)
    assert got.summary() == want.summary()
    # one recorder that saw every request reads the same
    assert got.summary() == _both(rows)[1].summary()
    h = ts[0].merged()
    assert h.merge(h).count == 2 * h.count


def _port_trace(path: Path) -> None:
    """A trace of the port's front door and service, exported as JSON
    lines."""
    from repro_torch.connectivity import registry, service
    tracer = tobs.enable(capacity=256)
    tracer.reset()
    try:
        reg = registry.GraphRegistry(device="cpu")
        svc = service.ConnectivityService(reg, slots=4)
        reg.create("g", 16)
        svc.submit_insert("g", [[0, 1], [2, 3]])
        svc.submit_query("g", "same_component", [[0, 1], [1, 2]])
        svc.submit_query("g", "count_components")
        svc.run()
        tobs.count("custom.counter", 3)
        tracer.export_jsonl(str(path))
    finally:
        tobs.disable()


@pytest.mark.parametrize("cmd", ["summary", "perfetto"])
def test_obs_cli_matches_reference(tmp_path, cmd):
    trace = tmp_path / "trace.jsonl"
    _port_trace(trace)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("repro", "repro_torch"):
        args = [sys.executable, "-m", f"{pkg}.obs", cmd, str(trace)]
        if cmd == "perfetto":
            args.append(str(tmp_path / "out.json"))
        proc = subprocess.run(args, env=env, cwd=tmp_path,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        written = None
        if cmd == "perfetto":
            written = json.loads((tmp_path / "out.json").read_text())
        out[pkg] = (proc.stdout, written)
    assert out["repro_torch"] == out["repro"]
    assert "service.tick" in out["repro"][0] or cmd == "perfetto"
