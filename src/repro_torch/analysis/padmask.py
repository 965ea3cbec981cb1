"""Pass ``padmask`` — every billed sum over a padded array is masked,
the port of ``repro.analysis.padmask``.

The engines pad every edge buffer to its pow2 bucket with (0, 0)
self-loops and carry the true count alongside. Self-loop padding is
*algebraically invisible* to the connectivity math (a self-loop never
merges anything) but NOT to additive statistics: an unmasked sum over
a padded hops / edges / per-round array bills the padding into
WorkCounters, the corruption the true-work billing tests exist to
catch, found here from the record instead.

Taint analysis over the recorded ops, in the order they ran:

* inputs marked ``padded=True`` in their ``VarInfo`` seed the
  ``padded`` taint; inputs marked ``mask=True`` (true counts, alive
  masks) seed the ``mask`` tag. A true count the entry takes as a
  Python int is a mask *value*: an op that meets that value as a scalar
  meets the mask;
* taints flow through shape ops and arithmetic (the union of the
  operands' tags); a comparison against a mask (``arange(E) <
  true_edges``) makes a new mask;
* **sanitizers**: ``where`` whose condition is a mask, ``mul`` / ``and``
  with a mask operand, and a prefix slice that ends at a mask value
  (``edges[:true_edges]``, the eager idiom) strip the ``padded`` taint:
  that IS the masking discipline, in any of its idioms;
* a gather (``index``, ``index_select``, ``gather``, ``take``,
  ``embedding``) keeps only its *operand's* taint: indexing a clean
  table with padded indices reads in-range rows, which bill nothing;
* the finding: a ``sum`` over a still-padded operand,
  ``unmasked-padded-sum``. Order- and idempotent reductions
  (min / max / and / or) over self-loop padding are correct by
  construction and never flagged.
"""
from __future__ import annotations

from typing import FrozenSet

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import Ref, TracedEntry

PASS_ID = "padmask"

CLEAN: FrozenSet[str] = frozenset()
PADDED = frozenset({"padded"})
MASK = frozenset({"mask"})

_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}
_SANITIZING_MUL = {"mul", "mul_", "bitwise_and", "bitwise_and_",
                   "logical_and", "logical_and_", "__and__"}
_AND = {"bitwise_and", "bitwise_and_", "logical_and", "logical_and_",
        "__and__"}
_GATHERS = {"index", "index_select", "gather", "take", "embedding"}
# scatters: the position of the updates they write into their first
_SCATTERS = {"scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_add": 3, "index_add_": 3, "index_copy": 3,
             "index_copy_": 3, "index_put": 2, "index_put_": 2,
             "_index_put_impl_": 2}


class _PadTaint:
    def __init__(self, traced: TracedEntry, mask_values: set):
        self.traced = traced
        self.mask_values = mask_values
        self.env: dict = {}
        self.findings: list[Finding] = []

    def tags(self, x) -> frozenset:
        if isinstance(x, Ref):
            return self.env.get(x.serial, CLEAN)
        if isinstance(x, tuple):
            out = CLEAN
            for y in x:
                out = out | self.tags(y)
            return out
        if isinstance(x, int) and not isinstance(x, bool) \
                and x in self.mask_values:
            return MASK
        return CLEAN

    def rule(self, op) -> frozenset:
        p, a = op.name, op.args
        vals = [self.tags(x) for x in a]
        union = CLEAN
        for v in vals:
            union = union | v
        if p == "where" and vals and "mask" in vals[0]:
            # where(alive, x, fill): the canonical sanitizer
            return (union - vals[0]) - PADDED | (vals[0] & MASK)
        if p in _SANITIZING_MUL and any("mask" in v for v in vals):
            return (union - PADDED) | (MASK if p in _AND else CLEAN)
        if p in _CMP and any("mask" in v for v in vals):
            return MASK               # iota < true_count -> a new mask
        if p == "slice" and len(a) >= 4 and a[1] == 0 \
                and a[2] in (0, None) and isinstance(a[3], int) \
                and a[3] in self.mask_values:
            return vals[0] - PADDED   # x[:true_count]: the eager prefix mask
        if p in _GATHERS:
            return vals[0] if vals else CLEAN
        if p in _SCATTERS and len(vals) > _SCATTERS[p]:
            return vals[0] | vals[_SCATTERS[p]]
        return union

    def visit(self, op) -> None:
        out = self.rule(op)
        if op.name == "sum" and op.args and "padded" in self.tags(op.args[0]):
            self.findings.append(Finding(
                PASS_ID, self.traced.name, "error", "unmasked-padded-sum",
                "`sum` over a padded array with no dominating alive / "
                "prefix mask — self-loop padding rows are billed into the "
                "sum (WorkCounters corruption); mask with "
                "`torch.where(alive, x, 0)`, multiply by the prefix mask or "
                "slice to the true count before summing",
                op.file, op.line))
            out = CLEAN        # one report per sink, not per consumer
        for r in op.outs:
            self.env[r.serial] = out


def run(traced: list[TracedEntry]) -> list[Finding]:
    findings: list[Finding] = []
    for t in traced:
        masks = {a.value for a, i in zip(t.args, t.arg_info)
                 if a.ref is None and getattr(i, "mask", False)
                 and isinstance(a.value, int) and a.value > 1}
        interp = _PadTaint(t, masks)
        for arg, info in zip(t.args, t.arg_info):
            if arg.ref is None:
                continue
            tags = CLEAN
            if getattr(info, "padded", False):
                tags = tags | PADDED
            if getattr(info, "mask", False):
                tags = tags | MASK
            interp.env[arg.ref.serial] = tags
        for op in t.record.ops:
            interp.visit(op)
        findings.extend(interp.findings)
    return findings
