"""Pass ``int32`` — interval analysis for index arithmetic, the port of
``repro.analysis.intrange``.

Labels and edge ids are int32 in both packages (the port casts to int64
only at a gather or scatter, where torch wants it). That makes int32
index *arithmetic* the one place where a clean-looking program silently
corrupts at scale: the incremental engine once keyed undirected edges
as ``min*V + max``, which is exact until |V| crosses ~46341 and then
wraps negative. CI-sized graphs never see it; the paper's scale graphs
always do. This pass re-derives that class of bug from the record:

* every flat input gets an inclusive value interval from its
  ``VarInfo`` (vertex ids in [0, |V|-1], counts in [0, |E|], unknown =
  TOP), and intervals flow through the recorded ops with exact Python-int
  arithmetic (no wrapping), in the order they ran — the record is
  straight-line, so loops are unrolled by the run and need no fixpoint;
* an ``add`` / ``sub`` / ``mul`` (in place or not) or ``_to_copy``
  whose *exact* result interval escapes [-2**31, 2**31-1] while its
  output dtype is a 32-bit-or-narrower int is an error
  ``<op>-overflow``: the runtime value has wrapped;
* a scalar argument is its own interval; shape ops, gathers and
  order-keeping reductions keep their operand's interval; an op with no
  rule gives TOP, and TOP never flags, so values the run computed
  through unknown ops (work counters, kernel outputs) produce no
  phantom findings.

Entries run at two buckets and the overflow only fires at the scale
bucket (V = 2**20): the checker sees what small-shape CI cannot.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import Ref, TracedEntry

PASS_ID = "int32"

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
TOP = None                                   # unknown interval
Interval = Optional[tuple]                   # (lo, hi) exact Python ints

_SMALL_INTS = (torch.int32, torch.int16, torch.int8, torch.uint8)
_FLAG = {"add": "add", "add_": "add", "sub": "sub", "sub_": "sub",
         "rsub": "sub", "mul": "mul", "mul_": "mul",
         "_to_copy": "_to_copy"}
_KEEP = {"view", "_unsafe_view", "reshape", "expand", "permute", "t",
         "transpose", "unsqueeze", "squeeze", "slice", "select", "clone",
         "contiguous", "alias", "detach", "flatten", "unflatten", "narrow",
         "repeat", "roll", "flip", "index", "index_select", "gather",
         "take", "embedding", "max", "min", "amax", "amin", "cummax",
         "cummin", "sort", "topk", "lift_fresh", "lift_fresh_copy",
         "_to_copy", "copy", "as_strided", "split", "split_with_sizes",
         "unbind", "chunk", "expand_as", "view_as", "movedim", "kthvalue",
         "median", "mode", "msort"}
# ops whose values are some of their arguments': the positions of those
_JOIN = {"where": (1, 2), "scatter": (0, 3), "scatter_": (0, 3),
         "index_copy": (0, 3), "index_copy_": (0, 3), "index_put": (0, 2),
         "index_put_": (0, 2), "_index_put_impl_": (0, 2),
         "masked_fill": (0, 2), "masked_fill_": (0, 2), "copy_": (1,)}
_BOOL = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
         "logical_not", "logical_xor", "isin", "any", "all", "isfinite"}


def _corners(a: Interval, b: Interval, op) -> Interval:
    if a is TOP or b is TOP:
        return TOP
    vals = [op(x, y) for x in a for y in b]
    return (min(vals), max(vals))


def _join(a: Interval, b: Interval) -> Interval:
    if a is TOP or b is TOP:
        return TOP
    return (min(a[0], b[0]), max(a[1], b[1]))


def _join_all(vals: list) -> Interval:
    out = vals[0] if vals else TOP
    for x in vals[1:]:
        out = _join(out, x)
    return out


class _IntRange:
    def __init__(self, traced: TracedEntry):
        self.traced = traced
        self.env: dict = {}
        self.findings: list[Finding] = []

    def val(self, x) -> Interval:
        if isinstance(x, Ref):
            if x.dtype == torch.bool:
                return (0, 1)
            return self.env.get(x.serial, TOP)
        if isinstance(x, bool):
            return (int(x), int(x))
        if isinstance(x, int):
            return (x, x)
        return TOP

    def rule(self, op) -> Interval:
        p, a = op.name, op.args
        v = [self.val(x) for x in a]
        if p in ("add", "add_", "sub", "sub_", "rsub") and len(v) >= 2:
            alpha = self.val(op.kwargs.get("alpha", 1))
            b = _corners(v[1], alpha, lambda x, y: x * y)
            if p == "rsub":
                return _corners(b, v[0], lambda x, y: x - y)
            return _corners(v[0], b, (lambda x, y: x + y)
                            if p.startswith("add") else (lambda x, y: x - y))
        if p in ("mul", "mul_") and len(v) >= 2:
            return _corners(v[0], v[1], lambda x, y: x * y)
        if p in ("maximum", "minimum", "clamp_min", "clamp_max") \
                and len(v) >= 2 and v[0] is not TOP and v[1] is not TOP:
            pick = max if p in ("maximum", "clamp_min") else min
            return (pick(v[0][0], v[1][0]), pick(v[0][1], v[1][1]))
        if p == "clamp" and v and v[0] is not TOP:
            lo = v[1] if len(v) > 1 and v[1] is not TOP else None
            hi = v[2] if len(v) > 2 and v[2] is not TOP else None
            return (max(v[0][0], lo[0]) if lo else v[0][0],
                    min(v[0][1], hi[1]) if hi else v[0][1])
        if p == "neg" and v and v[0] is not TOP:
            return (-v[0][1], -v[0][0])
        if p == "abs" and v and v[0] is not TOP:
            lo, hi = v[0]
            return (0 if lo <= 0 <= hi else min(abs(lo), abs(hi)),
                    max(abs(lo), abs(hi)))
        if p == "arange":
            ints = [x for x in a if isinstance(x, int)]
            if not ints:
                return TOP
            start, end = (0, ints[0]) if len(ints) == 1 else ints[:2]
            return (start, max(end - 1, start))
        if p in ("argmax", "argmin", "argsort") and a and isinstance(a[0],
                                                                    Ref):
            return (0, max(int(torch.Size(a[0].shape).numel()) - 1, 0))
        if p in ("full", "fill", "fill_", "full_like", "new_full"):
            fill = next((self.val(x) for x in a[1:] if not isinstance(
                x, (tuple, Ref))), TOP)
            return fill
        if p in ("zeros", "zeros_like", "new_zeros", "zero_"):
            return (0, 0)
        if p in ("ones", "ones_like", "new_ones"):
            return (1, 1)
        if p in ("remainder", "fmod") and len(v) >= 2 and v[1] is not TOP:
            m = max(abs(v[1][0]), abs(v[1][1]))
            if m > 0:
                return (-(m - 1), m - 1) if p == "fmod" else (0, m - 1)
        if p == "cumsum" and v and v[0] is not TOP:
            n = max(int(torch.Size(a[0].shape).numel()), 1)
            lo, hi = v[0]
            return (min(lo, lo * n), max(hi, hi * n))
        if p == "sum" and a and isinstance(a[0], Ref) \
                and a[0].dtype == torch.bool:
            return (0, int(torch.Size(a[0].shape).numel()))
        if p in _BOOL:
            return (0, 1)
        if p in _KEEP and v:
            return v[0]
        if p in ("cat", "stack") and a and isinstance(a[0], tuple):
            return _join_all([self.val(x) for x in a[0]])
        if p in _JOIN:
            return _join_all([v[i] if i < len(v) else TOP for i in _JOIN[p]])
        return TOP

    def visit(self, op) -> None:
        out = self.rule(op)
        name = _FLAG.get(op.name)
        if name and out is not TOP and op.outs \
                and op.outs[0].dtype in _SMALL_INTS \
                and (out[0] < INT32_MIN or out[1] > INT32_MAX):
            v, e = self.traced.bucket
            self.findings.append(Finding(
                PASS_ID, self.traced.name, "error", f"{name}-overflow",
                f"int32 `{op.name}` with exact value interval "
                f"[{out[0]}, {out[1]}] at bucket (V={v}, E={e}) — wraps "
                "past 2**31-1 on the device (the min*V+max edge-key "
                "class of bug; use segment ids, int64 keys, or a "
                "(min, max) pair instead of a packed product key)",
                op.file, op.line))
            out = TOP              # a wrapped value is unknowable downstream
        for r in op.outs:
            self.env[r.serial] = out if r.dtype != torch.bool else (0, 1)


def run(traced: list[TracedEntry]) -> list[Finding]:
    findings: list[Finding] = []
    for t in traced:
        interp = _IntRange(t)
        for arg, info in zip(t.args, t.arg_info):
            rng = getattr(info, "range", None)
            if arg.ref is not None and rng is not None:
                interp.env[arg.ref.serial] = tuple(int(x) for x in rng)
        for op in t.record.ops:
            interp.visit(op)
        findings.extend(interp.findings)
    return findings
