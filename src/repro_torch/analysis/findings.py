"""Findings — the structured output of every checker pass, the port of
``repro.analysis.findings``.

A ``Finding`` names the pass that produced it, the traced entry (or
file, for the AST lint) it anchors to, a severity, a human message,
and — when the recorded op's call site resolved — a ``file:line``
anchor into the repo. Findings carry a stable ``key`` (pass, entry,
site, code) used for two things:

  * **suppression pragmas** — a ``# analysis: ok[<pass-id>]`` comment
    on (or immediately above) the anchored source line acknowledges a
    finding in place, the same way ``# noqa`` works;
  * **baseline gating** — ``python -m repro_torch.analysis`` compares
    the current finding keys against a committed baseline
    (``analysis_baseline_torch.json``, in the reference's format) and
    exits nonzero only on NEW keys, so a pre-existing acknowledged
    violation cannot block CI while any regression does. Keys
    deliberately exclude line numbers (an unrelated edit must not
    invalidate the baseline) and bucket-dependent numbers in messages.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Optional

PASS_IDS = ("transfer", "int32", "retrace", "padmask", "kernel-ast")
SEVERITIES = ("error", "warning")

_PRAGMA = re.compile(r"#\s*analysis:\s*ok\[([a-z0-9, -]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_id: str                  # one of PASS_IDS
    entry: str                    # traced entry name / linted file
    severity: str                 # "error" | "warning"
    code: str                     # short machine code, e.g. "mul-overflow"
    message: str                  # human account (may include numbers)
    file: Optional[str] = None    # repo-relative source anchor
    line: Optional[int] = None

    @property
    def key(self) -> str:
        """Stable identity for baselines: excludes line numbers and
        message text (both drift under unrelated edits)."""
        return f"{self.pass_id}:{self.entry}:{self.file or '-'}:{self.code}"

    def render(self) -> str:
        site = f"{self.file}:{self.line}" if self.file else "-"
        return (f"{self.severity}[{self.pass_id}] {self.entry} @ {site}: "
                f"{self.message}")


def _line_has_pragma(path: Path, line: int, pass_id: str) -> bool:
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return False
    for n in (line, line - 1):                 # the line or the one above
        if not 1 <= n <= len(lines):
            continue
        text = lines[n - 1]
        if n == line - 1 and not text.lstrip().startswith("#"):
            continue           # line-above form must be a pure comment
        m = _PRAGMA.search(text)
        if m and pass_id in [p.strip() for p in m.group(1).split(",")]:
            return True
    return False


def apply_suppressions(findings: Iterable[Finding], root: Path
                       ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (kept, suppressed) by source pragmas."""
    kept, suppressed = [], []
    for f in findings:
        if f.file and f.line and _line_has_pragma(
                root / f.file, f.line, f.pass_id):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


def dedupe(findings: Iterable[Finding]) -> list[Finding]:
    """One finding per key (the multi-bucket sweep re-derives the same
    site at every shape bucket; report it once)."""
    seen, out = set(), []
    for f in findings:
        if f.key not in seen:
            seen.add(f.key)
            out.append(f)
    return out


@dataclasses.dataclass
class Report:
    findings: list = dataclasses.field(default_factory=list)
    suppressed: list = dataclasses.field(default_factory=list)
    entries_checked: list = dataclasses.field(default_factory=list)
    passes_run: list = dataclasses.field(default_factory=list)

    def new_vs(self, baseline_keys: set[str]) -> list[Finding]:
        return [f for f in self.findings if f.key not in baseline_keys]

    def to_json(self) -> dict:
        return {
            "passes": list(self.passes_run),
            "entries": list(self.entries_checked),
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "suppressed": [dataclasses.asdict(f) for f in self.suppressed],
        }


def load_baseline(path: Path) -> set[str]:
    """Committed baseline = the set of acknowledged finding keys."""
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("keys", []))


def write_baseline(path: Path, report: Report) -> None:
    path.write_text(json.dumps(
        {"keys": sorted({f.key for f in report.findings})}, indent=2)
        + "\n")
