"""The sweep: run every entry, run every pass, gate on the
baseline; the port of ``repro.analysis.runner``.

Buckets: every entry runs at a CI-sized bucket AND a scale-tier bucket
(|V| = 2^20, |E| = 2^22), the reference's. The reference traces both
symbolically; the port runs both on real inputs (drawn by
``graph_utils.trace``), so the scale tier costs a few seconds of host
time an entry. The int32 pass exists for exactly this split: the
``min*V+max`` overflow class is invisible at CI shapes and guaranteed
at paper shapes.

Findings are deduped by key across buckets, filtered through source
suppression pragmas, and compared against the committed baseline
(``analysis_baseline_torch.json``); only NEW keys gate.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from repro_torch.analysis import astlint, intrange, padmask, retrace, \
    transfers
from repro_torch.analysis.findings import (PASS_IDS, Report,
                                           apply_suppressions, dedupe)
from repro_torch.analysis.graph_utils import repo_root, trace
from repro_torch.graphs.device import resolve_device

# (num_nodes, num_edges): the CI tier and the paper's scale tier
BUCKETS = {"small": (1024, 4096), "scale": (1 << 20, 1 << 22)}

_RECORD_PASSES = (transfers, intrange, retrace, padmask)


def analyze(entries: Optional[list] = None, *,
            buckets: Optional[dict] = None,
            root: Optional[Path] = None,
            run_astlint: bool = True, device=None) -> Report:
    """Run ``entries`` (default: every registered entry) at every
    bucket on ``device`` (CUDA unless given; raises without CUDA unless
    ``device="cpu"``), run the pass stack, and return the gated
    ``Report``."""
    device = resolve_device(device)
    if entries is None:
        from repro_torch.analysis.entries import all_entries
        entries = all_entries()
    buckets = dict(buckets or BUCKETS)
    root = root or repo_root()

    findings = []
    for e in entries:
        for b in buckets.values():
            traced = [trace(e, b, device=device)]
            for pass_mod in _RECORD_PASSES:
                findings.extend(pass_mod.run(traced))
    passes = [p.PASS_ID for p in _RECORD_PASSES]
    if run_astlint:
        findings.extend(astlint.run(root))
        passes.append(astlint.PASS_ID)
    assert set(passes) <= set(PASS_IDS)

    kept, suppressed = apply_suppressions(dedupe(findings), root)
    kept.sort(key=lambda f: (f.severity != "error", f.pass_id, f.entry))
    return Report(findings=kept, suppressed=suppressed,
                  entries_checked=sorted({e.name for e in entries}),
                  passes_run=passes)


def selftest(device=None) -> list[str]:
    """Run the pass stack over the seeded-bug fixtures on ``device`` (as
    ``analyze``); return the list of failures (empty = the analyzer
    still catches every bug class it was built from)."""
    from repro_torch.analysis import fixtures

    failures: list[str] = []
    fixture_by_name = {e.name: e for e in fixtures.fixture_entries()}

    for name, (pass_id, code, where) in fixtures.EXPECTED.items():
        entry = fixture_by_name[name]
        for bucket_name, bucket in BUCKETS.items():
            rep = analyze([entry], buckets={bucket_name: bucket},
                          run_astlint=False, device=device)
            hit = any(f.pass_id == pass_id and f.code == code
                      for f in rep.findings)
            must_hit = where == "any" or bucket_name == where
            if must_hit and not hit:
                failures.append(
                    f"{name}: expected {pass_id}/{code} at bucket "
                    f"{bucket_name}{bucket}, not flagged")
            if where == "scale" and bucket_name == "small" and hit:
                failures.append(
                    f"{name}: {pass_id}/{code} fired at the SMALL "
                    "bucket — the scale-only asymmetry is broken")

    for name in sorted(fixtures.CLEAN):
        rep = analyze([fixture_by_name[name]], run_astlint=False,
                      device=device)
        if rep.findings:
            failures.append(
                f"{name}: clean twin produced findings: "
                + "; ".join(f.render() for f in rep.findings))
    return failures
