"""Adaptive segmentation heuristic (paper §III-B).

The paper splits the edge list into ``s = 2|E| / |V|`` segments — i.e.
segments of ≈ |V|/2 edges — so that every Atomic-Hook round touches a
working set proportional to the |V|-sized parent workspace, and a full
O(|V|) Multi-Jump compress runs between rounds. Pure Python: a copy of
``repro.core.segmentation``, kept field-for-field identical so that the
port plans exactly the segments the reference plans.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SegmentationPlan:
    """Static segmentation plan (shapes must be known at trace time)."""

    num_edges: int          # true edge count
    num_nodes: int
    num_segments: int       # s
    segment_size: int       # padded per-segment edge count
    padded_edges: int       # num_segments * segment_size

    @property
    def avg_degree(self) -> float:
        return 2.0 * self.num_edges / max(self.num_nodes, 1)


def adaptive_num_segments(num_edges: int, num_nodes: int) -> int:
    """The paper's heuristic: s = 2|E|/|V| (at least 1)."""
    if num_nodes <= 0:
        return 1
    return max(1, int(round(2.0 * num_edges / num_nodes)))


def plan_segmentation(
    num_edges: int,
    num_nodes: int,
    num_segments: int | None = None,
) -> SegmentationPlan:
    """Build a static plan; ``num_segments=None`` uses the adaptive heuristic."""
    s = num_segments if num_segments is not None else adaptive_num_segments(
        num_edges, num_nodes)
    s = max(1, min(s, max(num_edges, 1)))
    seg = int(math.ceil(max(num_edges, 1) / s))
    return SegmentationPlan(
        num_edges=num_edges,
        num_nodes=num_nodes,
        num_segments=s,
        segment_size=seg,
        padded_edges=s * seg,
    )
