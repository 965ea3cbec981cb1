"""Pass ``retrace`` — shape-bucket hygiene, the port of
``repro.analysis.retrace``.

``repro_torch.core.batch`` owns the rule: device programs take pow2
shape buckets, so a stream of arbitrary-sized inputs meets a bounded
set of shapes. The reference guards a retrace storm: one XLA compile
per distinct shape. The port compiles nothing per shape, but the rule
still guards three things in an eager port: the caching allocator's
block reuse (a new size is a new block, and a stream of sizes fragments
the pool), any ``torch.compile`` or CUDA graph capture laid over the
path (one graph per shape, as in the reference), and the kernels'
launch geometry (the fused scan's plan, and with it its sweep billing,
follows the padded edge count). This pass lints the recorded entries
against that rule:

* an entry contracted ``bucketed`` whose flat tensor input has a
  non-pow2 leading dimension, ``non-pow2-shape-argN`` (error);
* a Python scalar in the flat signature, ``python-scalar-argN``
  (warning): the counterpart of the reference's weak-typed aval; under
  ``torch.compile`` each distinct value specializes a graph;
* a large constant built from host data inside the entry (more than
  1 MiB, from ``torch.tensor`` / ``as_tensor`` / ``asarray`` /
  ``from_numpy``), other than an arange, ``large-captured-const``
  (warning): a host build and copy per call; thread it through as an
  argument.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import TracedEntry

PASS_ID = "retrace"

_CONST_FLAG_BYTES = 1 << 20          # 1 MiB of host-built constant


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def run(traced: list[TracedEntry]) -> list[Finding]:
    findings: list[Finding] = []
    for t in traced:
        bucketed = "bucketed" in t.entry.contracts
        for i, arg in enumerate(t.args):
            if arg.ref is None:
                if isinstance(arg.value, (bool, int, float)):
                    findings.append(Finding(
                        PASS_ID, t.name, "warning", f"python-scalar-arg{i}",
                        f"input {i} is a Python {type(arg.value).__name__} "
                        f"({arg.value!r}) — a value in the flat signature; "
                        "under torch.compile each distinct value "
                        "specializes a graph. Pass a device scalar instead"))
                continue
            shape = arg.ref.shape
            if bucketed and shape and not _is_pow2(int(shape[0])):
                findings.append(Finding(
                    PASS_ID, t.name, "error", f"non-pow2-shape-arg{i}",
                    f"input {i} has leading dim {shape[0]} (shape "
                    f"{shape}) on a bucketed entry — one allocation block "
                    "and one captured graph per distinct size; round up "
                    "with `next_pow2` / `pad_pow2` before dispatch"))
        for h in t.record.host:
            if h.kind == "put" and h.nbytes > _CONST_FLAG_BYTES \
                    and not h.iota:
                findings.append(Finding(
                    PASS_ID, t.name, "warning", "large-captured-const",
                    f"a {h.nbytes >> 10} KiB constant built from host data "
                    f"(`{h.method}`) inside the entry: built and copied on "
                    "every call; thread it through as an argument (an "
                    "arange is the one exempt pattern)",
                    h.file, h.line))
    return findings
