"""Solver: the one front door of the port (``repro.api.solver``, its
static half).

``Solver.open(graph_or_edges, **opts)`` returns a session that handles:

  * **static solve**: ``solve()`` routes through the adaptive policy
    (``method="auto"``: autotune cache, then the paper's heuristic) or
    any forced method or backend, dispatching through ``BACKENDS``;
  * **the spanning forest**: ``spanning_forest()``, cached per method;
  * **queries**: every ``connectivity.queries`` lookup, answered from
    the session's canonical labels, query batches padded to power-of-two
    row counts;
  * **inspection**: ``plan()`` reifies the adaptive decision as an
    ``ExecutionPlan`` whose ``explain()`` shows the backend, the shape
    bucket, the segmentation and the predicted work before anything
    runs.

One-shot: ``repro_torch.api.solve(graph, ...) -> CCResult``.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md queue A item: ``insert`` / ``delete`` and the metrics of the
dynamic engine (A6), ``solve_batch`` (A8), ``mesh=`` sessions (A10).

The session lives on one device: a host graph goes to ``device`` (CUDA
when None; with no CUDA it raises), a ``DeviceGraph`` or tensor stays
where it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.registry import get_backend
from repro_torch.connectivity import policy, queries
from repro_torch.core.batch import bucket_shape, pad_rows_pow2
from repro_torch.core.cc import ALL_METHODS, CCResult
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import (DeviceGraph, as_device_graph,
                                       resolve_device)
from repro_torch.obs import trace as obs

# method spellings a plan accepts beyond "auto" (each is a backend name)
_PLANNABLE = tuple(ALL_METHODS) + ("pallas", "hostloop")

# per-call backend options plan()/solve() accept via **opts, validated so
# that a misspelt option raises instead of running with defaults
_KNOWN_OPTS = frozenset({"hostloop_method"})


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item {item})")


class Solver:
    """A connectivity session over one vertex set. Use ``open()``."""

    def __init__(self, graph: DeviceGraph | None, num_nodes: int, *,
                 lift_steps: int = 2, num_segments: int | None = None,
                 policy_cache: policy.AutotuneCache | None = None,
                 name: str = "solver", device=None):
        self._graph = graph            # the opened graph (None: empty)
        self._device = graph.device if graph is not None \
            else resolve_device(device)
        self.num_nodes = int(num_nodes)
        self.lift_steps = lift_steps
        self.num_segments = num_segments
        self.policy_cache = policy_cache
        self.name = name
        self._labels = None            # cached static-solve labels
        self._forest: dict = {}        # method -> ForestResult
        self._empty = None             # cached empty DeviceGraph
        self.last_method: str | None = None
        self.last_plan: ExecutionPlan | None = None
        self.stats = {"solves": 0}

    # -- session lifecycle ---------------------------------------------------

    @classmethod
    def open(cls, graph=None, num_nodes: int | None = None, *,
             lift_steps: int = 2, num_segments: int | None = None,
             mesh=None, policy_cache: policy.AutotuneCache | None = None,
             name: str = "solver", device=None) -> "Solver":
        """Open a session.

        Args:
          graph: a ``DeviceGraph``, a host ``Graph``, or a raw [E, 2]
            edge array or tensor (then ``num_nodes`` is required), or
            ``None`` for an edgeless session over ``num_nodes`` vertices.
          num_nodes: |V| for raw arrays and empty sessions.
          lift_steps: bounded root-chase depth (all engines).
          num_segments: override the s = 2|E|/|V| heuristic.
          mesh: not ported yet (raises).
          policy_cache: autotune cache for ``method="auto"`` routing
            (None: the process-wide default cache).
          name: label for introspection.
          device: where host data goes (CUDA when None).
        """
        if mesh is not None:
            raise _not_ported("Solver.open(mesh=...)", "A10")
        if graph is None:
            if num_nodes is None:
                raise ValueError("Solver.open() needs a graph or "
                                 "num_nodes")
            g, n = None, int(num_nodes)
        else:
            g = as_device_graph(graph, num_nodes,
                                num_segments=num_segments, device=device)
            n = g.num_nodes
        return cls(g, n, lift_steps=lift_steps, num_segments=num_segments,
                   policy_cache=policy_cache, name=name, device=device)

    def graph(self) -> DeviceGraph:
        """The session's edge set as a DeviceGraph (an empty one for an
        edgeless session)."""
        if self._graph is not None:
            return self._graph
        if self._empty is None:
            self._empty = DeviceGraph.from_edges(
                np.zeros((0, 2), np.int32), self.num_nodes,
                name=self.name, device=self._device)
        return self._empty

    @property
    def num_edges(self) -> int:
        """The host-known true edge count (no sync)."""
        return self._graph.num_edges if self._graph is not None else 0

    # -- planning ------------------------------------------------------------

    def plan(self, method: str = "auto", *, backend: str | None = None,
             num_segments: int | None = None, **opts) -> ExecutionPlan:
        """The ``ExecutionPlan`` a ``solve()`` with the same arguments
        would run, before any device work. ``backend=`` forces a
        registry entry; a named ``method`` maps to its same-named
        backend; "auto" asks the policy (autotune cache, then the
        heuristic). Passing both a named method and a backend raises."""
        plan = self._build_plan(method, backend=backend,
                                num_segments=num_segments, **opts)
        self.last_plan = plan
        return plan

    def _build_plan(self, method: str = "auto", *,
                    backend: str | None = None,
                    num_segments: int | None = None,
                    **opts) -> ExecutionPlan:
        if backend is not None and method not in (None, "auto"):
            raise ValueError(
                f"pass method={method!r} OR backend={backend!r}, not "
                "both — a forced backend must not silently reroute a "
                "named method")
        unknown = set(opts) - _KNOWN_OPTS
        if unknown:
            raise TypeError(
                f"unknown option(s) {sorted(unknown)}; per-call backend "
                f"options are {sorted(_KNOWN_OPTS)}")
        g = self.graph()
        num_segments = self.num_segments if num_segments is None \
            else num_segments
        n, e = self.num_nodes, self.num_edges
        if backend is not None:
            get_backend(backend)                      # validates early
            chosen, reason = backend, "forced"
        elif method not in (None, "auto"):
            if method not in _PLANNABLE:
                raise ValueError(f"unknown method {method!r}; choose "
                                 f"from {('auto',) + _PLANNABLE} or "
                                 "force a backend= from "
                                 "repro_torch.api.BACKENDS")
            chosen, reason = method, "forced"
        else:
            # the skew feature was measured once at host ingest (None for
            # edges that arrived as a tensor): it sends skewed graphs at
            # scale to the sampled engine
            chosen, reason = policy.select_static_explained(
                n, e, degree_skew=g.degree_skew, cache=self.policy_cache)
        seg = g.plan if num_segments is None else plan_segmentation(
            int(g.edges.shape[0]), n, num_segments)
        predicted = {"hook_ops_per_round": e,
                     "jump_ops_per_sweep": n,
                     "segments": seg.num_segments}
        if g.degree_skew is not None:
            predicted["degree_skew"] = round(float(g.degree_skew), 3)
        return ExecutionPlan(
            backend=chosen, reason=reason, num_nodes=n, num_edges=e,
            bucket=bucket_shape(n, e), segmentation=seg,
            lift_steps=self.lift_steps, num_segments=num_segments,
            graph=g, opts=dict(opts), predicted=predicted)

    # -- static solve --------------------------------------------------------

    def solve(self, method: str = "auto", *, backend: str | None = None,
              num_segments: int | None = None, **opts) -> CCResult:
        """Solve the session's edge set; returns ``CCResult(labels,
        work)`` with canonical min-id labels. Routing is ``plan()``'s."""
        plan = self.plan(method, backend=backend,
                         num_segments=num_segments, **opts)
        if obs.enabled():
            with obs.span("solver.solve", tenant=self.name,
                          **plan.trace_tags()):
                res = plan.run()
        else:
            res = plan.run()
        self.stats["solves"] += 1
        self.last_method = plan.backend
        self._labels = res.labels
        return res

    def spanning_forest(self, method: str | None = None):
        """Labels plus the spanning forest the hook rounds record:
        ``ForestResult(labels, parents, work)``, ``parents`` int32
        [V, 2] with row r the graph edge whose hook retired root r and
        (-1, -1) for the one root per component (its minimum).

        ``method=None`` asks the policy and falls back to ``adaptive``
        when the chosen backend records no forest; forcing a method that
        records none raises. The result is cached per method (a static
        session's edge set never changes)."""
        from repro_torch.core import cc as cc_mod
        if method is None:
            chosen, _ = policy.select_static_explained(
                self.num_nodes, self.num_edges,
                degree_skew=self.graph().degree_skew,
                cache=self.policy_cache)
            method = chosen if chosen in cc_mod.FOREST_METHODS \
                else "adaptive"
        if method not in self._forest:
            with obs.span("solver.spanning_forest", tenant=self.name,
                          method=method):
                self._forest[method] = cc_mod.solve_forest(
                    self.graph(), method=method,
                    num_segments=self.num_segments,
                    lift_steps=self.lift_steps)
        return self._forest[method]

    @classmethod
    def solve_batch(cls, graphs, **kw):
        raise _not_ported("Solver.solve_batch", "A8")

    # -- streaming mutation (not ported) -------------------------------------

    def insert(self, edges):
        raise _not_ported("Solver.insert", "A6")

    def delete(self, edges):
        raise _not_ported("Solver.delete", "A6")

    def enable_metrics(self) -> None:
        raise _not_ported("Solver.enable_metrics", "A6")

    def metrics_summary(self):
        raise _not_ported("Solver.metrics_summary", "A6")

    # -- state views ---------------------------------------------------------

    @property
    def labels(self) -> torch.Tensor:
        """Canonical min-id labels of the edge set (on the device),
        solved with ``method="auto"`` on first access, without touching
        ``stats``, ``last_method`` or ``last_plan``."""
        if self._labels is None:
            self._labels = self._build_plan().run().labels
        return self._labels

    @property
    def version(self) -> int:
        """Label version: 0 (a static session never mutates)."""
        return 0

    @property
    def version_device(self) -> torch.Tensor:
        """Label version as a device scalar."""
        return torch.zeros((), dtype=torch.int32, device=self._device)

    @property
    def work(self) -> dict:
        """Accumulated mutation work counters: zeros (no mutations)."""
        from repro_torch.core.rounds import WorkCounters
        return {k: 0 for k in WorkCounters._fields}

    # -- queries (over the session's labels) ---------------------------------

    def _check_vertices(self, batch: np.ndarray) -> None:
        if batch.size and (batch.min() < 0
                           or batch.max() >= self.num_nodes):
            raise ValueError(
                f"vertex out of range [0, {self.num_nodes})")

    def same_component(self, pairs) -> np.ndarray:
        """bool [Q] for an int [Q, 2] pair batch."""
        pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
        self._check_vertices(pairs)
        q = pairs.shape[0]
        with obs.span("solver.query.same_component", tenant=self.name,
                      rows=q):
            return queries.to_host(queries.same_component(
                self.labels, pad_rows_pow2(pairs)))[:q]

    def connected(self, u: int, v: int) -> bool:
        """Scalar convenience over ``same_component``."""
        return bool(self.same_component([[u, v]])[0])

    def component_size(self, vertices) -> np.ndarray:
        """int32 [Q] component sizes for a vertex batch."""
        vertices = np.asarray(vertices, np.int32).reshape(-1)
        self._check_vertices(vertices)
        q = vertices.shape[0]
        with obs.span("solver.query.component_size", tenant=self.name,
                      rows=q):
            return queries.to_host(queries.component_size(
                self.labels, pad_rows_pow2(vertices)))[:q]

    def component_sizes(self) -> torch.Tensor:
        """int32 [V] size of every vertex's component (on the device)."""
        return queries.component_sizes(self.labels)

    def num_components(self) -> int:
        """The number of components (one sort and boundary count)."""
        with obs.span("solver.query.num_components", tenant=self.name):
            return int(queries.count_components(self.labels))

    def component_histogram(self) -> np.ndarray:
        """Components per power-of-two size bin."""
        with obs.span("solver.query.component_histogram",
                      tenant=self.name):
            return queries.to_host(
                queries.component_histogram(self.labels))

    def __repr__(self) -> str:
        return (f"Solver(name={self.name!r}, |V|={self.num_nodes}, "
                f"|E|~{self.num_edges}, mode=static)")


def solve(graph, num_nodes: int | None = None, method: str = "auto", *,
          backend: str | None = None, num_segments: int | None = None,
          lift_steps: int = 2, mesh=None,
          policy_cache: policy.AutotuneCache | None = None, device=None,
          **opts) -> CCResult:
    """One-shot facade solve: ``Solver.open(...).solve(...)``."""
    return Solver.open(graph, num_nodes, lift_steps=lift_steps,
                       num_segments=num_segments, mesh=mesh,
                       policy_cache=policy_cache, device=device).solve(
        method, backend=backend, **opts)
