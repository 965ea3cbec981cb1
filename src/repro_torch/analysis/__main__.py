"""``python -m repro_torch.analysis`` — the invariant gate, the port of
``python -m repro.analysis``.

Exit codes: 0 = no findings beyond the committed baseline,
1 = new violations (listed, marked NEW), 2 = ``--selftest`` failure
(the analyzer stopped catching its own seeded bug fixtures).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.analysis.findings import load_baseline, write_baseline
from repro_torch.analysis.graph_utils import repo_root
from repro_torch.analysis.runner import analyze, selftest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Invariant checker over every registered backend's "
                    "recorded run.")
    ap.add_argument("--baseline", type=Path,
                    default=repo_root() / "analysis_baseline_torch.json",
                    help="committed baseline of acknowledged finding "
                         "keys (default: analysis_baseline_torch.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current "
                         "findings and exit 0")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="dump the full findings report as JSON")
    ap.add_argument("--selftest", action="store_true",
                    help="run the pass stack over the seeded-bug "
                         "fixtures instead of the repo sweep")
    ap.add_argument("--entry", action="append", default=None,
                    help="restrict the sweep to entries whose name "
                         "contains this substring (repeatable)")
    ap.add_argument("--device", default=None,
                    help="where the entries run (default: CUDA; 'cpu' "
                         "runs them on the CPU)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()

    if args.selftest:
        failures = selftest(args.device)
        dt = time.perf_counter() - t0
        if failures:
            for f in failures:
                print(f"selftest FAIL: {f}")
            print(f"selftest: {len(failures)} failure(s) in {dt:.1f}s")
            return 2
        print(f"selftest: all seeded fixtures caught ({dt:.1f}s)")
        return 0

    entries = None
    if args.entry:
        from repro_torch.analysis.entries import all_entries
        entries = [e for e in all_entries()
                   if any(s in e.name for s in args.entry)]
        if not entries:
            print(f"no entries match {args.entry}", file=sys.stderr)
            return 2

    report = analyze(entries, device=args.device)
    dt = time.perf_counter() - t0

    if args.json:
        args.json.write_text(json.dumps(report.to_json(), indent=2) + "\n")

    if args.write_baseline:
        write_baseline(args.baseline, report)
        print(f"baseline written: {args.baseline} "
              f"({len(report.findings)} key(s))")
        return 0

    baseline = load_baseline(args.baseline)
    new = {f.key for f in report.new_vs(baseline)}
    for f in report.findings:
        tag = "NEW " if f.key in new else "    "
        print(f"{tag}{f.render()}")
    stale = baseline - {f.key for f in report.findings}
    for key in sorted(stale):
        print(f"    (baseline key no longer fires: {key})")

    print(f"checked {len(report.entries_checked)} entries x "
          f"{len(report.passes_run)} passes in {dt:.1f}s: "
          f"{len(report.findings)} finding(s) "
          f"({len(new)} new, {len(report.suppressed)} suppressed, "
          f"baseline {len(baseline)})")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
