"""ExecutionPlan: the adaptive decision as an inspectable object (the
port of ``repro.api.plan``).

``Solver.plan()`` says which backend runs and why (forced, a measured
autotune winner, or the paper's heuristic), which power-of-two shape
bucket the graph lands in (the autotune key), the segmentation plan
(s = 2|E|/|V|) and the predicted per-round work. ``plan.explain()``
renders it; ``plan.run()`` executes it through the ``BACKENDS``
registry. A plan is host metadata: building one touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.segmentation import SegmentationPlan
from repro_torch.obs import trace as obs


@dataclasses.dataclass
class ExecutionPlan:
    """One routed execution: backend choice + everything that drove it."""

    backend: str                   # BACKENDS key that will run
    reason: str                    # forced | autotune | heuristic | policy | sharded
    num_nodes: int
    num_edges: int                 # true edges when statically known
    bucket: tuple                  # pow2 (V_pad, E_pad): the autotune key
    segmentation: Optional[SegmentationPlan]
    lift_steps: int = 2
    num_segments: Optional[int] = None      # caller override (None = heuristic)
    graph: Any = dataclasses.field(default=None, repr=False)
    graphs: Any = dataclasses.field(default=None, repr=False)   # batched plans
    opts: dict = dataclasses.field(default_factory=dict, repr=False)
    predicted: dict = dataclasses.field(default_factory=dict)
    artifacts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def bucket_key(self) -> str:
        """The autotune-cache spelling of the shape bucket."""
        return f"v{self.bucket[0]}_e{self.bucket[1]}"

    def run(self):
        """Execute through the registered backend; returns its
        ``CCResult``. Extra outputs land in ``self.artifacts``. Traced
        as a ``plan.run`` span tagged with the plan's provenance when
        ``repro_torch.obs`` tracing is enabled."""
        from repro_torch.api.registry import get_backend
        if not obs.enabled():
            return get_backend(self.backend).run(self)
        with obs.span("plan.run", **self.trace_tags()):
            return get_backend(self.backend).run(self)

    def as_dict(self) -> dict:
        """The decision as one plain-JSON dict: the schema that the
        ``explain()`` renderer and the tracer's span tags share."""
        seg = self.segmentation
        return {
            "backend": self.backend,
            "reason": self.reason,
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "density": 2.0 * self.num_edges / max(self.num_nodes, 1),
            "bucket": list(self.bucket),
            "bucket_key": self.bucket_key,
            "lift_steps": self.lift_steps,
            "num_segments": self.num_segments,
            "batch_size": (len(self.graphs) if self.graphs is not None
                           else None),
            "segmentation": None if seg is None else {
                "num_segments": seg.num_segments,
                "segment_size": seg.segment_size,
                "padded_edges": seg.padded_edges,
                "source": ("override" if self.num_segments is not None
                           else "s=2|E|/|V| heuristic"),
            },
            "predicted": dict(self.predicted),
        }

    def trace_tags(self) -> dict:
        """The provenance subset of ``as_dict()`` that rides on every
        span touching this plan: backend, why it won, shape bucket."""
        d = self.as_dict()
        return {"backend": d["backend"], "reason": d["reason"],
                "bucket": d["bucket_key"]}

    def explain(self) -> str:
        """Human-readable account of the adaptive decision (rendered
        from ``as_dict()`` — same fields the tracer tags see)."""
        from repro_torch.api.registry import BACKENDS
        d = self.as_dict()
        lines = [f"plan: backend={d['backend']} ({d['reason']})"]
        if d["batch_size"] is not None:
            lines.append(f"  batch: {d['batch_size']} graphs, "
                         f"total |E|={d['num_edges']}")
        lines.append(f"  graph: |V|={d['num_nodes']} |E|={d['num_edges']} "
                     f"density={d['density']:.2f} "
                     f"bucket={d['bucket_key']}")
        s = d["segmentation"]
        if s is not None:
            lines.append(f"  segmentation: {s['num_segments']} segment(s)"
                         f" x {s['segment_size']} edges "
                         f"(padded {s['padded_edges']}; {s['source']})")
        if d["predicted"]:
            lines.append("  predicted: " + " ".join(
                f"{k}={v}" for k, v in sorted(d["predicted"].items())))
        backend = BACKENDS.get(self.backend)
        if backend is not None:
            lines.append(f"  capabilities: "
                         f"{backend.capabilities.describe()}")
        return "\n".join(lines)
