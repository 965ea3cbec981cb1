"""CLI for trace files (the port of ``repro.obs.__main__``):
``python -m repro_torch.obs summary <trace.jsonl>`` renders per-span-name
latency aggregates + counters from a JSON-lines export; ``python -m
repro_torch.obs perfetto <trace.jsonl> <out.json>`` converts one to the
Chrome ``trace_event`` format for the Perfetto UI.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import chrome_trace_events, span_summary


def _load(path: str) -> tuple[list, dict, int]:
    """Parse a JSON-lines export -> (span events, counters, dropped)."""
    spans, counters, dropped = [], {}, 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "span":
                spans.append(rec)
            elif rec.get("type") == "counters":
                counters.update(rec.get("counters", {}))
                dropped = rec.get("dropped", 0)
    return spans, counters, dropped


def cmd_summary(path: str) -> int:
    spans, counters, dropped = _load(path)
    summ = span_summary(spans)
    if not summ:
        print(f"{path}: no spans")
    else:
        name_w = max(len(n) for n in summ) + 2
        print(f"{'span':<{name_w}}{'count':>8}{'total_ms':>12}"
              f"{'p50_us':>10}{'p99_us':>12}")
        for name, row in summ.items():
            print(f"{name:<{name_w}}{row['count']:>8}"
                  f"{row['total_ms']:>12.3f}{row['p50_us']:>10.1f}"
                  f"{row['p99_us']:>12.1f}")
    if dropped:
        print(f"\n({dropped} oldest spans dropped by the ring buffer)")
    if counters:
        print("\ncounters:")
        for name in sorted(counters):
            print(f"  {name} = {counters[name]}")
    return 0


def cmd_perfetto(path: str, out: str) -> int:
    spans, _, _ = _load(path)
    with open(out, "w") as fh:
        json.dump(chrome_trace_events(spans), fh)
    print(f"wrote {len(spans)} events to {out} "
          f"(load in https://ui.perfetto.dev or chrome://tracing)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summary", help="render span/counter aggregates")
    ps.add_argument("trace", help="JSON-lines trace file")
    pp = sub.add_parser("perfetto",
                        help="convert a JSONL trace to Chrome trace_event")
    pp.add_argument("trace", help="JSON-lines trace file")
    pp.add_argument("out", help="output .json path")
    args = p.parse_args(argv)
    if args.cmd == "summary":
        return cmd_summary(args.trace)
    return cmd_perfetto(args.trace, args.out)


if __name__ == "__main__":
    sys.exit(main())
