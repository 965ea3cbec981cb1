"""Adaptive method selection, the paper's heuristic as a policy: the
port of ``repro.connectivity.policy``.

1. **Heuristic** (``heuristic_method``), on O(1) features (|V|, |E|,
   density 2|E|/|V|, degree skew, update and delete rates):

   * a small pending insert batch is an ``incremental-absorb``; a small
     pending delete batch a ``tombstone-delete`` route (the ``-forest``
     one where most edges are not tree edges, the ``-fused`` one where
     the autotune cache measured ``pallas_fused`` the winner). The
     ``Solver``'s mutation path runs them on ``core.incremental``'s
     ``DynamicCC``;
   * a skewed graph at scale goes to ``sampled``;
   * density < ``MIN_SEGMENT_DENSITY``: ``atomic_hook``;
   * density >= ``LABELPROP_DENSITY_FRAC`` * |V|: ``labelprop``;
   * otherwise ``adaptive`` (the paper's Fig. 4).

2. **Autotune cache** (``AutotuneCache``): measured winners per
   power-of-two (V_pad, E_pad) bucket, persisted as JSON
   (``{"version": 1, "entries": {"v1024_e4096": {"method": ..., "ms":
   ...}, ...}}``). ``measure`` times the candidates on the graph's own
   device: the kernel backends too on a CUDA graph, the torch-op engines
   only on a CPU graph (where a kernel runs its plain version, whose
   time says nothing about the kernel). ``REPRO_TORCH_AUTOTUNE_CACHE``
   names the default cache's file: a cache measured for another device
   family (``REPRO_AUTOTUNE_CACHE`` of the reference) must not route
   this one.

Selection order in ``select_method``: the update-rate rule first, then
an autotune-cache hit, then the heuristic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.obs import trace as obs

# the static engines the heuristic chooses between; the fused kernel
# backend and the k-out sampling engine join the measured (autotune)
# candidate set below
STATIC_METHODS = ("adaptive", "atomic_hook", "labelprop")
AUTOTUNE_METHODS = STATIC_METHODS + ("pallas_fused", "sampled")
INCREMENTAL_ABSORB = "incremental-absorb"
# delete-path routes: tombstone + scoped recompute over
# the affected components only — the fused variant runs the scoped scan
# through the cc_fused kernel (one launch); a bulk delete falls through
# to a static rebuild over the surviving log instead
DYNAMIC_DELETE = "tombstone-delete"
DYNAMIC_DELETE_FUSED = "tombstone-delete-fused"
# the tree-aware route: classify the batch against the
# maintained spanning forest, short-circuit all-non-tree batches, and
# reconnect via the forest skeleton + replacement edges otherwise
DYNAMIC_DELETE_FOREST = "tombstone-delete-forest"
DELETE_METHODS = (DYNAMIC_DELETE, DYNAMIC_DELETE_FUSED,
                  DYNAMIC_DELETE_FOREST)

# heuristic thresholds (see module docstring)
UPDATE_RATE_ABSORB = 0.5       # delta/total above this is a bulk load
DELETE_RATE_SCOPED = 0.5       # deletes/alive above this is a bulk drop
# tree-hit-rate routing: min(|V|-1, |E|)/|E| bounds the fraction of
# alive edges that can be spanning-tree edges — i.e. the expected
# tree-hit rate of a uniform delete batch. Below the threshold most
# deletes are non-tree and the forest route's short-circuit/skeleton
# reconnection wins; near 1 (road-like |E| ~ |V|) nearly every delete
# IS a tree edge and the plain scoped recompute is already right-sized
FOREST_TREE_RATIO = 0.75
MIN_SEGMENT_DENSITY = 1.5      # below: s = round(2E/V) <= 1 segment
LABELPROP_DENSITY_FRAC = 0.25  # density >= frac*V: near-clique regime
# k-out sampling routing (Hong et al.): max_degree/mean_degree above
# SAMPLED_SKEW marks a power-law/kron-like graph where the sampling
# phase collapses the giant component cheaply; road-like graphs sit
# near 1 and skip it. The edge floor keeps tiny graphs (the whole test
# corpus) on the exact engines — sampling's two extra phases
# only pay for themselves at scale.
SAMPLED_SKEW = 8.0
SAMPLED_MIN_EDGES = 4096

CACHE_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class GraphFeatures:
    """Cheap selection features — all O(1) from array shapes."""

    num_nodes: int
    num_edges: int              # edges already absorbed (static: total)
    delta_edges: int | None = None    # pending insert batch (None: static)
    delta_deletes: int | None = None  # pending delete batch (None: static)
    degree_skew: float | None = None  # max_deg/mean_deg (None: unmeasured)

    @property
    def total_edges(self) -> int:
        return self.num_edges + (self.delta_edges or 0)

    @property
    def remaining_edges(self) -> int:
        """Post-delete edge-count upper bound (a delete row retires at
        most every copy of one edge; absent rows retire nothing)."""
        return max(self.num_edges - (self.delta_deletes or 0), 0)

    @property
    def density(self) -> float:
        """The paper's segmentation key: 2|E|/|V| (average degree)."""
        return 2.0 * self.total_edges / max(self.num_nodes, 1)

    @property
    def update_rate(self) -> float:
        """|delta E| / |E total| — 0 for a static (no-delta) call."""
        if self.delta_edges is None:
            return 0.0
        return self.delta_edges / max(self.total_edges, 1)

    @property
    def delete_rate(self) -> float:
        """|delete batch| / |E alive| — the delete-side twin of
        ``update_rate``: a batch small relative to the surviving set is
        worth scoping, a bulk drop is worth a static rebuild."""
        if self.delta_deletes is None:
            return 0.0
        return self.delta_deletes / max(self.num_edges, 1)

    @property
    def tree_edge_ratio(self) -> float:
        """Upper bound on the fraction of alive edges that are
        spanning-tree edges: min(|V|-1, |E|)/|E| — the expected
        tree-hit rate of a uniform delete batch (the delete-route
        feature behind ``FOREST_TREE_RATIO``)."""
        if self.num_edges <= 0:
            return 1.0
        return min(self.num_nodes - 1, self.num_edges) / self.num_edges


def extract_features(num_nodes: int, num_edges: int,
                     delta_edges: int | None = None,
                     delta_deletes: int | None = None,
                     degree_skew: float | None = None) -> GraphFeatures:
    return GraphFeatures(num_nodes=int(num_nodes),
                         num_edges=int(num_edges),
                         delta_edges=None if delta_edges is None
                         else int(delta_edges),
                         delta_deletes=None if delta_deletes is None
                         else int(delta_deletes),
                         degree_skew=None if degree_skew is None
                         else float(degree_skew))




def heuristic_method(f: GraphFeatures) -> str:
    """The paper's segmentation heuristic as a method choice."""
    if f.delta_deletes is not None:
        if f.num_edges > 0 and f.delete_rate <= DELETE_RATE_SCOPED:
            if f.tree_edge_ratio <= FOREST_TREE_RATIO:
                # mostly-non-tree regime: the maintained-forest route
                # short-circuits the common all-non-tree batch
                return DYNAMIC_DELETE_FOREST
            return DYNAMIC_DELETE
        # bulk drop: a static engine over the surviving edge set beats
        # scoping (most components are affected anyway)
        return heuristic_method(GraphFeatures(f.num_nodes,
                                              f.remaining_edges))
    if (f.delta_edges is not None and f.num_edges > 0
            and f.update_rate <= UPDATE_RATE_ABSORB):
        return INCREMENTAL_ABSORB
    if f.num_nodes <= 1 or f.total_edges == 0:
        return "adaptive"              # trivial either way
    if (f.degree_skew is not None and f.degree_skew >= SAMPLED_SKEW
            and f.total_edges >= SAMPLED_MIN_EDGES
            and f.density >= MIN_SEGMENT_DENSITY):
        return "sampled"               # skewed at scale: sampling wins
    if f.density < MIN_SEGMENT_DENSITY:
        return "atomic_hook"
    if f.density >= LABELPROP_DENSITY_FRAC * f.num_nodes:
        return "labelprop"
    return "adaptive"


# ---------------------------------------------------------------------------
# Measured autotune cache
# ---------------------------------------------------------------------------

class AutotuneCache:
    """Measured best-method table keyed on the power-of-two shape bucket.

    JSON format (``CACHE_FORMAT_VERSION``)::

        {"version": 1,
         "entries": {"v1024_e4096": {"method": "adaptive", "ms": 1.93,
                                     "num_nodes": 1000, "num_edges": 3900},
                     ...}}

    A lookup for any graph landing in a recorded bucket returns the
    measured winner; ``measure`` times the static candidates and
    records one. ``path=None`` keeps the table in memory only.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        # {method: median ms} of the last measure() call
        self.last_timings: dict[str, float] = {}
        if path and os.path.exists(path):
            self.load()

    @staticmethod
    def key(num_nodes: int, num_edges: int) -> str:
        from repro_torch.core.batch import bucket_shape
        v_pad, e_pad = bucket_shape(num_nodes, num_edges)
        return f"v{v_pad}_e{e_pad}"

    def lookup(self, num_nodes: int, num_edges: int) -> str | None:
        ent = self.entries.get(self.key(num_nodes, num_edges))
        # always-on obs counters: cold-cache serving (miss-heavy
        # steady state) must be visible in the tick summary
        obs.count("autotune.hit" if ent else "autotune.miss")
        return ent["method"] if ent else None

    def record(self, num_nodes: int, num_edges: int, method: str,
               ms: float) -> None:
        self.entries[self.key(num_nodes, num_edges)] = {
            "method": method, "ms": round(float(ms), 4),
            "num_nodes": int(num_nodes), "num_edges": int(num_edges)}
        if self.path:
            self.save()

    def save(self) -> None:
        """Atomic write: a process-unique temp file in the target dir +
        an atomic rename (``os.replace`` — rename semantics with
        cross-platform overwrite) — two concurrent
        ``ConnectivityService`` processes can interleave saves without
        ever corrupting the JSON (a fixed ``.tmp`` name would let their
        writes interleave in the SAME temp file; last rename still
        wins, but both renames are atomic)."""
        payload = {"version": CACHE_FORMAT_VERSION, "entries": self.entries}
        target = os.path.abspath(self.path)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target),
                                   prefix=os.path.basename(target) + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self) -> None:
        with open(self.path) as fh:
            payload = json.load(fh)
        if payload.get("version") != CACHE_FORMAT_VERSION:
            return                      # stale format: start fresh
        self.entries = dict(payload.get("entries", {}))

    def measure(self, edges, num_nodes: int | None = None,
                methods: tuple[str, ...] | None = None,
                reps: int = 2, *, device=None) -> str:
        """Time each candidate on this graph through the facade
        (``repro_torch.api.solve``), record the winner for its shape
        bucket and return it.

        ``edges`` is a ``DeviceGraph``, a host ``Graph``, an edge tensor
        or a host [E, 2] array (then ``num_nodes`` is needed; host data
        goes to ``device``, CUDA when None). The graph is placed once, so
        the candidates are timed on a device-resident graph, as an opened
        ``Solver`` runs them. ``methods=None`` takes
        ``AUTOTUNE_METHODS`` on a CUDA graph and ``STATIC_METHODS`` on a
        CPU one. Every rep synchronizes the device before its timer
        starts and after the solve, so no candidate is charged for
        another's queued work."""
        from repro_torch.api import solve
        from repro_torch.graphs.device import as_device_graph
        g = as_device_graph(edges, num_nodes, device=device)
        if methods is None:
            methods = AUTOTUNE_METHODS if g.device.type == "cuda" \
                else STATIC_METHODS

        def sync():
            if g.device.type == "cuda":
                import torch
                torch.cuda.synchronize(g.device)

        best_method, best_ms = None, float("inf")
        timings = {}
        for method in methods:
            solve(g, method=method)
            ts = []
            for _ in range(reps):
                sync()                          # quiesce before t0
                t0 = time.perf_counter()
                solve(g, method=method)
                sync()
                ts.append(time.perf_counter() - t0)
            ms = float(np.median(ts)) * 1e3
            timings[method] = ms
            if ms < best_ms:
                best_method, best_ms = method, ms
        self.last_timings = timings
        self.record(g.num_nodes, g.num_edges, best_method, best_ms)
        return best_method


def warm_start(graphs, cache: AutotuneCache, reps: int = 2, *,
               device=None) -> AutotuneCache:
    """Warm start: measure every graph's bucket once (host graphs go to
    ``device``)."""
    for g in graphs:
        if cache.lookup(g.num_nodes, g.num_edges) is None:
            cache.measure(g, reps=reps, device=device)
    return cache


_default_cache: AutotuneCache | None = None


def default_cache() -> AutotuneCache:
    """Process-wide cache; persisted iff ``REPRO_TORCH_AUTOTUNE_CACHE``
    names a JSON path."""
    global _default_cache
    if _default_cache is None:
        _default_cache = AutotuneCache(
            os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE"))
    return _default_cache


# ---------------------------------------------------------------------------
# The selection entry point
# ---------------------------------------------------------------------------

def select_static_explained(num_nodes: int, num_edges: int, *,
                            degree_skew: float | None = None,
                            cache: AutotuneCache | None = None
                            ) -> tuple[str, str]:
    """Static-solve selection WITH its provenance: ``(method, reason)``
    where reason is ``"autotune"`` (measured cache hit for the shape
    bucket) or ``"heuristic"`` (the paper's density rule, including the
    degree-skew sampling rule when the caller measured skew at ingest).
    This is what ``repro_torch.api`` plans report via
    ``ExecutionPlan.explain()`` — ``select_method`` routes through it
    so the facade's account of the decision can never drift from the
    decision itself."""
    f = extract_features(num_nodes, num_edges, degree_skew=degree_skew)
    cache = default_cache() if cache is None else cache
    with obs.span("policy.select", num_nodes=f.num_nodes,
                  num_edges=f.total_edges) as sp:
        hit = cache.lookup(f.num_nodes, f.total_edges)
        if hit is not None:
            sp.tag(method=hit, reason="autotune")
            return hit, "autotune"
        choice = heuristic_method(f)
        sp.tag(method=choice, reason="heuristic")
        return choice, "heuristic"


def select_method(num_nodes: int, num_edges: int, *,
                  delta_edges: int | None = None,
                  delta_deletes: int | None = None,
                  degree_skew: float | None = None,
                  cache: AutotuneCache | None = None) -> str:
    """Pick the execution method from graph features.

    Static callers (``connected_components(method="auto")``) pass sizes
    only and get a method from ``STATIC_METHODS``; the registry's
    insert path also passes ``delta_edges`` and may get
    ``"incremental-absorb"`` back; its delete path passes
    ``delta_deletes`` and may get a ``DELETE_METHODS`` route back — the
    fused variant when the autotune cache's measured winner for the
    surviving-graph bucket is ``pallas_fused`` (measured truth decides
    which kernel backend runs the scoped scan, same as it decides the
    static engine). Autotuned winners override the heuristic for the
    static choice.
    """
    if delta_edges is None and delta_deletes is None:
        # static call: one shared path with the facade's plan(), so
        # ExecutionPlan.explain() can never drift from the selection
        return select_static_explained(num_nodes, num_edges,
                                       degree_skew=degree_skew,
                                       cache=cache)[0]
    f = extract_features(num_nodes, num_edges, delta_edges, delta_deletes)
    choice = heuristic_method(f)
    if choice == INCREMENTAL_ABSORB:
        return choice
    if choice == DYNAMIC_DELETE_FOREST:
        # the tree-aware route has no fused variant: its hot path is
        # the short-circuit (no scan at all), and the scoped phases run
        # over packed skeleton/crossing sets the fused kernel's
        # segment-boundary prefetch does not model
        return choice
    cache = default_cache() if cache is None else cache
    if choice == DYNAMIC_DELETE:
        hit = cache.lookup(f.num_nodes, max(f.remaining_edges, 1))
        return DYNAMIC_DELETE_FUSED if hit == "pallas_fused" else choice
    lookup_edges = f.total_edges if f.delta_deletes is None \
        else max(f.remaining_edges, 1)
    hit = cache.lookup(f.num_nodes, lookup_edges)
    return hit if hit is not None else choice


def select_for(num_nodes: int, num_edges: int, delta=None, *,
               delete: bool = False,
               cache: AutotuneCache | None = None) -> str:
    """The registry's mutation-path selection over a pending
    ``DeviceGraph`` delta: the update/delete-rate feature comes from
    the delta's host-known true edge count — no device
    sync, no host round trip of edge data. ``delete=True`` routes the
    batch through the delete-side heuristic (scoped tombstone delete
    vs full static rebuild over the survivors)."""
    size = None if delta is None else delta.num_edges
    with obs.span("policy.select_for", num_edges=num_edges, delta=size,
                  delete=delete) as sp:
        method = select_method(
            num_nodes, num_edges,
            delta_edges=None if delete else size,
            delta_deletes=size if delete else None,
            cache=cache)
        sp.tag(method=method)
        return method
