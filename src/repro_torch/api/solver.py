"""Solver: the one front door of the port (``repro.api.solver``).

``Solver.open(graph_or_edges, **opts)`` returns a session that handles:

  * **static solve**: ``solve()`` routes through the adaptive policy
    (``method="auto"``: autotune cache, then the paper's heuristic) or
    any forced method or backend, dispatching through ``BACKENDS``;
  * **streaming mutation**: ``insert()`` / ``delete()`` promote the
    session to the fully-dynamic engine and route every batch through
    ``policy.select_for`` (a small insert is absorbed, a bulk one
    rebuilds through a static engine and is adopted; a small delete
    tombstones and recomputes the affected components, on torch ops,
    the fused kernel or the maintained forest, a bulk drop rebuilds
    over the survivors);
  * **the spanning forest**: ``spanning_forest()``, cached per method
    and label version;
  * **queries**: every ``connectivity.queries`` lookup, answered from
    the session's canonical labels, query batches padded to power-of-two
    row counts;
  * **inspection**: ``plan()`` reifies the adaptive decision as an
    ``ExecutionPlan`` whose ``explain()`` shows the backend, the shape
    bucket, the segmentation and the predicted work before anything
    runs.

One-shot: ``repro_torch.api.solve(graph, ...) -> CCResult``; fleets:
``Solver.solve_batch(graphs)``; a ``mesh=`` session (a
``repro_torch.launch.mesh.Mesh``) plans the ``distributed`` backend,
the multi-shard engine.

The session lives on one device: a host graph goes to ``device`` (CUDA
when None, or slot 0's device of a ``mesh``; with no CUDA it raises), a
``DeviceGraph`` or tensor stays where it is.
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
                                       resolve_device, validate_edge_bounds)
from repro_torch.obs import trace as obs

# method spellings a plan accepts beyond "auto" (each is a backend name)
_PLANNABLE = tuple(ALL_METHODS) + ("pallas", "hostloop")

# per-call backend options plan()/solve() accept via **opts, validated so
# that a misspelt option raises instead of running with defaults
_KNOWN_OPTS = frozenset({"hostloop_method"})


class Solver:
    """A connectivity session over one vertex set. Use ``open()``."""

    def __init__(self, graph: DeviceGraph | None, num_nodes: int, *,
                 lift_steps: int = 2, num_segments: int | None = None,
                 policy_cache: policy.AutotuneCache | None = None,
                 mesh=None, axis_names=("data",),
                 scan_method: str | None = None,
                 delete_route: str | None = None,
                 name: str = "solver", device=None):
        self._graph = graph            # the opened graph (None: empty)
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self._device = graph.device if graph is not None \
            else resolve_device(device)
        self.num_nodes = int(num_nodes)
        self.lift_steps = lift_steps
        self.num_segments = num_segments
        self.policy_cache = policy_cache
        self._scan_method = scan_method   # force the scoped-scan backend
        if delete_route is not None \
                and delete_route not in policy.DELETE_METHODS:
            raise ValueError(f"unknown delete_route {delete_route!r}; "
                             f"choose from {policy.DELETE_METHODS} or "
                             "None (policy-routed)")
        self._delete_route = delete_route  # force the delete-side route
        self.name = name
        self._dyn = None               # live dynamic state (lazy)
        self._labels = None            # cached static-solve labels
        # (method, ForestResult, label version at build): kept while the
        # version is unchanged (an absorb that merged nothing leaves the
        # partition, and so the forest, as it was)
        self._forest = None
        self._empty = None             # cached empty DeviceGraph
        self.last_method: str | None = None
        self.last_plan: ExecutionPlan | None = None
        self.stats = {"solves": 0, "inserts": 0, "deletes": 0,
                      "absorbs": 0, "scoped_deletes": 0,
                      "forest_deletes": 0, "rebuilds": 0}

    # -- session lifecycle ---------------------------------------------------

    @classmethod
    def open(cls, graph=None, num_nodes: int | None = None, *,
             lift_steps: int = 2, num_segments: int | None = None,
             mesh=None, axis_names=("data",),
             policy_cache: policy.AutotuneCache | None = None,
             scan_method: str | None = None,
             delete_route: str | None = None,
             name: str = "solver", device=None) -> "Solver":
        """Open a session.

        Args:
          graph: a ``DeviceGraph``, a host ``Graph``, or a raw [E, 2]
            edge array or tensor (then ``num_nodes`` is required), or
            ``None`` for an edgeless session over ``num_nodes`` vertices.
          num_nodes: |V| for raw arrays and empty sessions.
          lift_steps: bounded root-chase depth (all engines).
          num_segments: override the s = 2|E|/|V| heuristic.
          mesh: a ``repro_torch.launch.mesh.Mesh``: plans default to
            the ``distributed`` backend over ``axis_names``, and host
            data goes to slot 0's device unless ``device`` is given.
          policy_cache: autotune cache for ``method="auto"`` routing
            (None: the process-wide default cache).
          scan_method: force the dynamic engine's scoped-scan backend
            (``"jnp"`` | ``"pallas_fused"``; None: policy-routed).
          delete_route: force the delete-side route (a
            ``policy.DELETE_METHODS`` entry; None: policy-routed by the
            delete-rate and tree-edge-ratio features).
          name: label for introspection.
          device: where host data goes (CUDA when None).
        """
        if device is None and mesh is not None:
            device = mesh.slot_devices(axis_names)[0]
        if graph is None:
            if num_nodes is None:
                raise ValueError("Solver.open() needs a graph or "
                                 "num_nodes")
            g, n = None, int(num_nodes)
        else:
            with obs.span("solver.open", tenant=name):
                g = as_device_graph(graph, num_nodes,
                                    num_segments=num_segments,
                                    device=device)
            n = g.num_nodes
        return cls(g, n, lift_steps=lift_steps, num_segments=num_segments,
                   mesh=mesh, axis_names=axis_names,
                   policy_cache=policy_cache, scan_method=scan_method,
                   delete_route=delete_route, name=name, device=device)

    def graph(self) -> DeviceGraph:
        """The current edge set as a DeviceGraph: the dynamic log's
        surviving (compacted) view once the session has mutated, else
        the opened graph (an empty one for an edgeless session)."""
        if self._dyn is not None and self._dyn.log.rows > 0:
            return self._dyn.graph()
        if self._dyn is None and self._graph is not None:
            return self._graph
        if self._empty is None:
            self._empty = DeviceGraph.from_edges(
                np.zeros((0, 2), np.int32), self.num_nodes,
                name=self.name, device=self._device)
        return self._empty

    @property
    def num_edges(self) -> int:
        """Host-known edge count (no sync): the inserted total of a
        mutated session (an upper bound under churn: the policy's size
        feature), else the opened graph's true count."""
        if self._dyn is not None:
            return self._dyn.num_edges_inserted
        return self._graph.num_edges if self._graph is not None else 0

    # -- planning ------------------------------------------------------------

    def plan(self, method: str = "auto", *, backend: str | None = None,
             num_segments: int | None = None, **opts) -> ExecutionPlan:
        """The ``ExecutionPlan`` a ``solve()`` with the same arguments
        would run, before any device work. ``backend=`` forces a
        registry entry; a named ``method`` maps to its same-named
        backend; "auto" asks the policy (autotune cache, then the
        heuristic). Passing both a named method and a backend raises."""
        with obs.span("solver.plan", tenant=self.name):
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
            caps = get_backend(backend).capabilities   # validates early
            if caps.batched:
                raise ValueError(
                    f"backend {backend!r} runs fleets, not single "
                    "graphs — use Solver.solve_batch(graphs)")
            if caps.sharded and self.mesh is None:
                raise ValueError(
                    f"backend {backend!r} needs a mesh — open the "
                    "session with Solver.open(graph, mesh=...)")
            chosen, reason = backend, "forced"
        elif method not in (None, "auto"):
            # a forced method wins over the mesh default
            if method not in _PLANNABLE:
                raise ValueError(f"unknown method {method!r}; choose "
                                 f"from {('auto',) + _PLANNABLE} or "
                                 "force a backend= from "
                                 "repro_torch.api.BACKENDS")
            chosen, reason = method, "forced"
        elif self.mesh is not None:
            chosen, reason = "distributed", "sharded"
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
            graph=g,
            opts={"mesh": self.mesh, "axis_names": self.axis_names,
                  **opts},
            predicted=predicted)

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
        records none raises. The result is cached on (method, label
        version): an ``insert()`` that merged nothing leaves the
        partition, and so the cached forest, valid. ``delete()`` always
        drops it (a deleted tree edge with a surviving replacement
        leaves the version as it was but kills a cached forest edge)."""
        from repro_torch.core import cc as cc_mod
        if method is None:
            chosen, _ = policy.select_static_explained(
                self.num_nodes, self.num_edges,
                degree_skew=self.graph().degree_skew,
                cache=self.policy_cache)
            method = chosen if chosen in cc_mod.FOREST_METHODS \
                else "adaptive"
        if self._forest is not None and self._forest[0] == method \
                and self._forest[2] == self.version:
            return self._forest[1]
        with obs.span("solver.spanning_forest", tenant=self.name,
                      method=method):
            res = cc_mod.solve_forest(self.graph(), method=method,
                                      num_segments=self.num_segments,
                                      lift_steps=self.lift_steps)
        self._forest = (method, res, self.version)
        return res

    @classmethod
    def solve_batch(cls, graphs, *, num_segments: int | None = None,
                    lift_steps: int = 2, device=None) -> list[CCResult]:
        """Fleet solve through the ``batched`` backend: one kernel launch
        per power-of-two shape bucket scan (and per cleanup round), one
        ``CCResult`` per graph in input order, labels and counters equal
        to the reference's. Host graphs run on ``device`` (CUDA when
        None) and come back on the CPU; a ``DeviceGraph`` fleet stays on
        its device."""
        graphs = list(graphs)
        sizes = [(g.num_nodes, g.num_edges)
                 if hasattr(g, "num_nodes")
                 else (int(g[1]), g[0].numel() // 2
                       if isinstance(g[0], torch.Tensor)
                       else int(np.asarray(g[0]).reshape(-1, 2).shape[0]))
                 for g in graphs]
        n = max((s[0] for s in sizes), default=0)
        e = sum(s[1] for s in sizes)
        plan = ExecutionPlan(
            backend="batched", reason="forced", num_nodes=n, num_edges=e,
            bucket=bucket_shape(n, e), segmentation=None,
            lift_steps=lift_steps, num_segments=num_segments,
            graphs=graphs, opts={"device": device},
            predicted={"n_graphs": len(graphs)})
        return plan.run()

    # -- streaming mutation (policy-routed) ---------------------------------

    def _coerce(self, edges) -> DeviceGraph:
        """Host arrays are validated and copied to the session's device;
        DeviceGraphs pass through (the caller owns their bounds)."""
        if isinstance(edges, DeviceGraph):
            if edges.num_nodes != self.num_nodes:
                raise ValueError(f"delta num_nodes {edges.num_nodes} != "
                                 f"{self.num_nodes}")
            return edges
        arr = np.asarray(edges, np.int32).reshape(-1, 2)
        validate_edge_bounds(arr, self.num_nodes)
        return DeviceGraph.from_edges(arr, self.num_nodes, name=self.name,
                                      device=self._device)

    @property
    def state(self):
        """The live dynamic engine (``DynamicCC``), made on first use by
        the ``dynamic`` backend's ``make_state``; a session opened with
        edges routes them through the policy as its first (bulk)
        insert."""
        return self._ensure_dyn()

    def _ensure_dyn(self):
        if self._dyn is None:
            self._dyn = get_backend("dynamic").make_state(
                self.num_nodes, lift_steps=self.lift_steps,
                scan_method=self._scan_method, device=self._device)
            if obs.enabled():
                # tracing on: carry the device Metrics through every
                # mutation (read only at metrics_summary())
                self._dyn.enable_metrics()
            seed, self._graph = self._graph, None
            if seed is not None and seed.num_edges:
                # the opened graph is the session's first (bulk) insert,
                # counted as one: inserts == absorbs + insert rebuilds
                self.stats["inserts"] += 1
                self._route_insert(seed)
        return self._dyn

    def _rebuild(self, method: str) -> CCResult:
        """Static rebuild over the current (staged) edge set through the
        policy-chosen backend: the bulk-mutation route."""
        plan = self.plan(method)
        plan.reason = "policy"
        self.last_plan = plan
        return plan.run()

    def _route_insert(self, delta: DeviceGraph) -> None:
        dyn = self._dyn
        method = policy.select_for(self.num_nodes, self.num_edges, delta,
                                   cache=self.policy_cache)
        self.last_method = method
        if method == policy.INCREMENTAL_ABSORB:
            dyn.insert_graph(delta)
            self.stats["absorbs"] += 1
        else:
            # bulk load: the accumulated set is mostly this batch, and the
            # chosen static engine (segmentation and all) beats hooking a
            # huge unsegmented delta through the absorb loop
            dyn.stage(delta)
            res = self._rebuild(method)
            dyn.adopt(res.labels, work=res.work, num_edges=delta.num_edges)
            self.stats["rebuilds"] += 1

    def insert(self, edges) -> torch.Tensor:
        """Insert an edge batch (DeviceGraph or host array); returns the
        label version as a device scalar (``int(...)`` it to read it).
        Routed by ``policy.select_for``: a small delta is absorbed, a
        bulk load rebuilds through a static engine and is adopted."""
        delta = self._coerce(edges)
        self._ensure_dyn()
        self.stats["inserts"] += 1
        # the spanning-forest cache stays: it is keyed on the version
        with obs.span("solver.insert", tenant=self.name,
                      edges=delta.num_edges) as sp:
            self._route_insert(delta)
            sp.tag(route=self.last_method)
        return self._dyn.version_device

    def delete(self, edges) -> torch.Tensor:
        """Delete an edge batch (each row retires every alive copy of
        that undirected edge; absent rows are no-ops); returns the label
        version as a device scalar. Routed by the delete-rate policy (or
        ``delete_route``): a small batch tombstones and recomputes the
        affected components (the version ticks iff one split), a bulk
        drop rebuilds over the survivors."""
        delta = self._coerce(edges)
        dyn = self._ensure_dyn()
        self.stats["deletes"] += 1
        self._forest = None            # edge set changed: forest stale
        with obs.span("solver.delete", tenant=self.name,
                      edges=delta.num_edges) as sp:
            method = self._delete_route if self._delete_route is not None \
                else policy.select_for(self.num_nodes, self.num_edges,
                                       delta, delete=True,
                                       cache=self.policy_cache)
            self.last_method = method
            sp.tag(route=method)
            if method == policy.DYNAMIC_DELETE_FOREST:
                dyn.delete_graph_forest(delta)
                self.stats["forest_deletes"] += 1
                self.stats["scoped_deletes"] += 1
            elif method in policy.DELETE_METHODS:
                if self._scan_method is None:
                    dyn.scan_method = "pallas_fused" \
                        if method == policy.DYNAMIC_DELETE_FUSED else "jnp"
                dyn.delete_graph(delta)
                self.stats["scoped_deletes"] += 1
            else:
                obs.count("dynamic.deletes.rebuild")
                dyn.tombstone_graph(delta)
                res = self._rebuild(method)
                dyn.adopt(res.labels, work=res.work)
                self.stats["rebuilds"] += 1
        return dyn.version_device

    def enable_metrics(self) -> None:
        """Attach the device ``Metrics`` accumulators to the dynamic
        engine (automatic when tracing was on before the first
        mutation). Read only by ``metrics_summary()``."""
        self._ensure_dyn().enable_metrics()

    @property
    def metrics(self):
        """The live device ``Metrics`` (None unless attached). Reading
        never syncs."""
        return self._dyn.metrics if self._dyn is not None else None

    def metrics_summary(self) -> dict | None:
        """The accumulators on the host (one explicit read back, through
        ``queries.to_host``); None when no metrics are attached."""
        m = self.metrics
        if m is None:
            return None
        from repro_torch.obs import metrics as obs_metrics
        return obs_metrics.flush(m)

    # -- state views ---------------------------------------------------------

    @property
    def labels(self) -> torch.Tensor:
        """Canonical min-id labels for the current edge set (on the
        device). A mutated session reads the live dynamic state; a
        static one solves with ``method="auto"`` on first access,
        without touching ``stats``, ``last_method`` or ``last_plan``."""
        if self._dyn is not None:
            return self._dyn.labels
        if self._labels is None:
            self._labels = self._build_plan().run().labels
        return self._labels

    @property
    def version(self) -> int:
        """Label version as a host int (syncs). Ticks exactly when a
        mutation changed the partition (a merge or a split)."""
        return self._dyn.version if self._dyn is not None else 0

    @property
    def version_device(self) -> torch.Tensor:
        """Label version as a device scalar (no sync)."""
        if self._dyn is not None:
            return self._dyn.version_device
        return torch.zeros((), dtype=torch.int32, device=self._device)

    @property
    def work(self) -> dict:
        """Accumulated mutation work counters (host ints; syncs), zeros
        before the first mutation."""
        if self._dyn is not None:
            return self._dyn.work
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
        mode = "dynamic" if self._dyn is not None else "static"
        return (f"Solver(name={self.name!r}, |V|={self.num_nodes}, "
                f"|E|~{self.num_edges}, mode={mode})")


def solve(graph, num_nodes: int | None = None, method: str = "auto", *,
          backend: str | None = None, num_segments: int | None = None,
          lift_steps: int = 2, mesh=None, axis_names=("data",),
          policy_cache: policy.AutotuneCache | None = None, device=None,
          **opts) -> CCResult:
    """One-shot facade solve: ``Solver.open(...).solve(...)``."""
    return Solver.open(graph, num_nodes, lift_steps=lift_steps,
                       num_segments=num_segments, mesh=mesh,
                       axis_names=axis_names, policy_cache=policy_cache,
                       device=device).solve(
        method, backend=backend, **opts)
