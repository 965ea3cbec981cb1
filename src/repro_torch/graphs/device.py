"""DeviceGraph — the device-resident graph the static solves consume.

The port of ``repro.graphs.device`` (its static half):

  * ``edges``      — int32 [E, 2] COO tensor on one device (possibly
                     padded with (0, 0) no-op self loops);
  * ``num_nodes``  — |V|;
  * ``true_edges`` — the unpadded edge count (work counters bill true
                     edges only);
  * ``plan``       — the attached ``SegmentationPlan``, keyed on the
                     paper's s = 2|E|/|V| heuristic over the TRUE edge
                     count, covering the stored (padded) edge array.

Padding invariant: rows past ``true_edges`` are (0, 0) self loops —
hook no-ops for every engine — and are never billed.

Placement: a graph built from host data lands on ``device``; with no
device given it lands on CUDA, and with no CUDA it raises rather than
run on the CPU unasked (``resolve_device``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.segmentation import (SegmentationPlan,
                                           adaptive_num_segments,
                                           plan_segmentation)

_MIN_PAD_ROWS = 8


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1); ``repro.core.batch.next_pow2``."""
    return 1 << max(0, int(max(x, 1) - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    CUDA. Raises when neither is possible — the port never falls back
    to the CPU unless the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def validate_edge_bounds(edges: np.ndarray, num_nodes: int) -> None:
    """Raise unless every endpoint lies in [0, num_nodes). Callers pass
    a HOST array."""
    edges = np.asarray(edges)
    if edges.size and (edges.min() < 0 or edges.max() >= num_nodes):
        raise ValueError(f"edge endpoint out of range [0, {num_nodes})")


def measure_degree_skew(edges: np.ndarray, num_nodes: int) -> float:
    """max_degree / mean_degree over the undirected degree sequence
    (~1 on road-like graphs, large on power-law ones). HOST arrays only:
    it runs once at host ingest in ``from_edges``."""
    edges = np.asarray(edges)
    if edges.size == 0 or num_nodes <= 0:
        return 1.0
    deg = np.bincount(
        np.concatenate([edges[:, 0], edges[:, 1]]), minlength=num_nodes)
    mean = 2.0 * edges.shape[0] / num_nodes
    return float(deg.max() / max(mean, 1e-9))


class DeviceGraph:
    """Device-resident COO graph + segmentation plan."""

    def __init__(self, edges: torch.Tensor, num_nodes: int,
                 true_edges: int, plan: SegmentationPlan,
                 name: str = "graph", degree_skew: float | None = None):
        self.edges = edges                     # int32 [E, 2]
        self.num_nodes = int(num_nodes)
        self.true_edges = int(true_edges)
        self.plan = plan
        self.name = name
        # max_degree / mean_degree, measured at host ingest (None when
        # the edges arrived as a tensor already)
        self.degree_skew = degree_skew

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_edges(cls, edges, num_nodes: int, *, true_edges=None,
                   num_segments: int | None = None,
                   name: str = "graph", device=None) -> "DeviceGraph":
        """Host numpy / lists are measured (``degree_skew``) and copied
        to ``device`` (CUDA when None). A tensor stays where it is
        unless ``device`` is given."""
        degree_skew = None
        if isinstance(edges, torch.Tensor):
            edges = edges.to(torch.int32).reshape(-1, 2)
            if device is not None:
                edges = edges.to(resolve_device(device))
        else:
            dev = resolve_device(device)
            host = np.asarray(edges, np.int32).reshape(-1, 2)
            t = host.shape[0] if true_edges is None else int(true_edges)
            degree_skew = measure_degree_skew(host[:t], int(num_nodes))
            edges = torch.from_numpy(host).to(dev)
        edges = edges.contiguous()
        e_stored = int(edges.shape[0])
        if true_edges is None:
            true_edges = e_stored
        plan = _plan_for(e_stored, int(num_nodes), int(true_edges),
                         num_segments)
        return cls(edges, int(num_nodes), int(true_edges), plan, name=name,
                   degree_skew=degree_skew)

    @classmethod
    def from_host(cls, graph, *, num_segments: int | None = None,
                  device=None) -> "DeviceGraph":
        """From a host ``repro_torch.graphs.format.Graph``."""
        return cls.from_edges(graph.edges, graph.num_nodes,
                              num_segments=num_segments,
                              name=getattr(graph, "name", "graph"),
                              device=device)

    @classmethod
    def from_reference(cls, edges: np.ndarray, num_nodes: int,
                       true_edges: int, num_segments: int, *,
                       device) -> "DeviceGraph":
        """Rebuild a reference ``repro.graphs.device.DeviceGraph`` from
        its fields as numpy: the stored (possibly padded) edge rows,
        |V|, the true count and ``plan.num_segments``. The plan comes
        out equal field by field, padded (``pad_pow2``) graphs
        included, because the reference plans its stored rows with the
        segment count it chose on the true count."""
        host = np.asarray(edges, np.int32).reshape(-1, 2)
        dev = resolve_device(device)
        plan = plan_segmentation(host.shape[0], int(num_nodes),
                                 int(num_segments))
        return cls(torch.from_numpy(host.copy()).to(dev), int(num_nodes),
                   int(true_edges), plan)

    # -- static metadata ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @property
    def true_edges_static(self) -> int:
        return self.true_edges

    @property
    def num_edges(self) -> int:
        """The true edge count."""
        return self.true_edges

    @property
    def density(self) -> float:
        """The paper's segmentation key 2|E|/|V|."""
        return 2.0 * self.num_edges / max(self.num_nodes, 1)

    # -- shaping -----------------------------------------------------------

    def pad_rows(self, target: int) -> "DeviceGraph":
        """Pad the stored edge array with (0, 0) no-ops to ``target``
        rows. ``true_edges`` is preserved."""
        e = int(self.edges.shape[0])
        if target <= e:
            return self
        pad = torch.zeros((target - e, 2), dtype=self.edges.dtype,
                          device=self.device)
        edges = torch.cat([self.edges, pad], dim=0)
        plan = _plan_for(target, self.num_nodes, self.true_edges, None)
        return DeviceGraph(edges, self.num_nodes, self.true_edges, plan,
                           name=self.name, degree_skew=self.degree_skew)

    def pad_pow2(self, min_rows: int = _MIN_PAD_ROWS) -> "DeviceGraph":
        """Pad to the next power-of-two row count (floored at
        ``min_rows``)."""
        e = int(self.edges.shape[0])
        return self.pad_rows(next_pow2(max(e, min_rows)))

    def __repr__(self) -> str:
        t = self.true_edges
        return (f"DeviceGraph(|V|={self.num_nodes}, "
                f"|E|={self.edges.shape[0]}"
                + (f", true={t}" if t != self.edges.shape[0] else "")
                + f", s={self.plan.num_segments}, name={self.name!r}, "
                f"device={self.device})")


def _plan_for(e_stored: int, num_nodes: int, true_edges: int,
              num_segments: int | None) -> SegmentationPlan:
    """Plan over the STORED row count, with the paper's s = 2|E|/|V|
    heuristic evaluated on the TRUE count (padding must not inflate the
    segment count)."""
    if num_segments is None:
        num_segments = adaptive_num_segments(int(true_edges), num_nodes)
    return plan_segmentation(e_stored, num_nodes, num_segments)


def as_device_graph(graph, num_nodes: int | None = None, *,
                    num_segments: int | None = None,
                    device=None) -> DeviceGraph:
    """Coerce any accepted graph spelling to a DeviceGraph:

      * a ``DeviceGraph`` — returned as-is (``num_segments`` override
        rebuilds the plan only);
      * a host ``Graph`` (anything with ``.edges``/``.num_nodes``);
      * raw ``(edges, num_nodes)`` arrays or tensors.
    """
    if isinstance(graph, DeviceGraph):
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != graph.device.type or (
                want.index is not None and want.index != graph.device.index)):
            raise ValueError(f"graph lives on {graph.device}, not {device}")
        if num_segments is not None and \
                num_segments != graph.plan.num_segments:
            plan = plan_segmentation(int(graph.edges.shape[0]),
                                     graph.num_nodes, num_segments)
            return DeviceGraph(graph.edges, graph.num_nodes,
                               graph.true_edges, plan, name=graph.name,
                               degree_skew=graph.degree_skew)
        return graph
    if hasattr(graph, "edges") and hasattr(graph, "num_nodes"):
        return DeviceGraph.from_edges(graph.edges, graph.num_nodes,
                                      num_segments=num_segments,
                                      name=getattr(graph, "name", "graph"),
                                      device=device)
    if num_nodes is None:
        raise ValueError("raw edge arrays need an explicit num_nodes")
    return DeviceGraph.from_edges(graph, num_nodes,
                                  num_segments=num_segments, device=device)
