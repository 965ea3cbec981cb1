"""Pass ``transfer`` — transfer-freedom, the port of
``repro.analysis.transfers``.

The serving contract says steady-state ticks (absorb, delete, coalesce,
plan) make zero host round trips. The reference proves it at trace
time: a jaxpr cannot stage a host read. An eager program can, so this
pass reads the run's record (``graph_utils.trace``) instead:

  1. **no host reads** — each read of a tensor on the entry's device
     (``item``, ``tolist``, ``numpy``, ``cpu``, ``to`` onto the CPU,
     ``__bool__``, ``__int__``, ``__index__``, ``__float__``,
     ``__array__``) is the error ``host-read-<method>`` on a
     ``transfer_free`` entry: on a card each one waits for the device;
  2. **no data-dependent shapes** — an aten op whose output size
     depends on the data is the error ``dynamic-shape-<op>``: the host
     must learn the size before it can allocate, so on a card it syncs.
     These are ``nonzero``, ``masked_select``, the ``unique`` family,
     ``repeat_interleave`` without ``output_size``, ``bincount``,
     ``_local_scalar_dense`` (what a read of a scalar dispatches), and
     ``index`` / ``index_put`` with a boolean mask (a hidden
     ``nonzero``);
  3. **no large host puts** — a tensor of more than 8 elements built
     from host data inside the entry (on a card, a host-to-device copy
     each call) is the warning ``large-host-put``. Scalar puts (the
     true-count idiom) are exempt.

An entry that is not contracted transfer-free (the hostloop steps,
contracted to sync) gets each of these as a warning. An entry that
raises is ``trace-failed``: an error on a contracted entry, a warning
elsewhere; the other passes did not see it either.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import Ref, TracedEntry

PASS_ID = "transfer"

DYNAMIC_SHAPE = ("nonzero", "masked_select", "unique", "_unique",
                 "_unique2", "unique_consecutive", "unique_dim",
                 "unique_dim_consecutive", "bincount",
                 "_local_scalar_dense")
_MASK_INDEXED = ("index", "index_put", "index_put_", "_index_put_impl_")
_MASKS = (torch.bool, torch.uint8)
_SCALAR_PUT_MAX_ELEMS = 8         # true-count / version scalars are fine


def dynamic_shape(op) -> bool:
    """Whether a recorded op's output size depends on its data."""
    if op.name in DYNAMIC_SHAPE:
        return True
    if op.name == "repeat_interleave":
        return op.kwargs.get("output_size") is None and op.overload in (
            "Tensor", "self_Tensor")
    if op.name in _MASK_INDEXED and len(op.args) > 1:
        idx = op.args[1] if isinstance(op.args[1], tuple) else ()
        return any(isinstance(r, Ref) and r.dtype in _MASKS for r in idx)
    return False


def host_reads(t: TracedEntry) -> list:
    """The run's host reads of tensors on its device."""
    return [h for h in t.record.host
            if h.kind == "read" and h.device == t.device]


def sync_points(t: TracedEntry) -> dict:
    """Where the run waits for the device, by kind: its host reads, its
    data-dependent shapes (``_local_scalar_dense`` counts beside the
    read that dispatched it), its tensors built from host data onto its
    device, scalars included, and the CPU tensors its ops copy there (a
    copy from pageable memory returns only once it is done; only a
    card's run has them). On a card each is a synchronizing call: their
    sum bounds what CUDA's sync debug mode counts for the same run."""
    return {"host_reads": len(host_reads(t)),
            "dynamic_shape": sum(map(dynamic_shape, t.record.ops)),
            "host_puts": sum(h.kind == "put" and h.device == t.device
                             for h in t.record.host),
            "host_copies": sum(op.host_copies for op in t.record.ops)}


def run(traced: list[TracedEntry]) -> list[Finding]:
    findings: list[Finding] = []
    for t in traced:
        contracted = "transfer_free" in t.entry.contracts
        sev = "error" if contracted else "warning"
        if t.failure is not None:
            first = (t.failure.message.splitlines() or [""])[0][:200]
            findings.append(Finding(
                PASS_ID, t.name, sev, "trace-failed",
                f"entry failed to run ({t.failure.exc_type}); the other "
                f"passes saw only its record up to the failure — {first}"))
        for h in host_reads(t):
            findings.append(Finding(
                PASS_ID, t.name, sev, f"host-read-{h.method}",
                f"`{h.method}` reads a {h.numel}-element tensor back to "
                "the host" + (" on a transfer-free contracted path (one "
                              "device round trip per call)" if contracted
                              else ""),
                h.file, h.line))
        for op in t.record.ops:
            if dynamic_shape(op):
                findings.append(Finding(
                    PASS_ID, t.name, sev, f"dynamic-shape-{op.name}",
                    f"`{op.name}` has a data-dependent output size: the "
                    "host waits for the device to learn it",
                    op.file, op.line))
        if contracted:
            for h in t.record.host:
                if h.kind == "put" and h.numel > _SCALAR_PUT_MAX_ELEMS:
                    findings.append(Finding(
                        PASS_ID, t.name, "warning", "large-host-put",
                        f"a {h.numel}-element tensor built from host data "
                        f"(`{h.method}`) inside a transfer-free contracted "
                        "program: a host-to-device copy per call",
                        h.file, h.line))
    return findings
