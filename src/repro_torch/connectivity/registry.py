"""Multi-tenant graph registry (the port of
``repro.connectivity.registry``): N named live graphs, versioned labels,
query-result caching with partition-precise invalidation.

Each tenant is a named vertex set backed by a ``repro_torch.api.Solver``
session: the facade owns the policy routing and the fully-dynamic state
(labels plus the device tombstone edge log), the tenant layer adds
naming, stats and query caching. Inserts are routed by
``policy.select_for`` (a small delta is absorbed, a bulk load rebuilt
through a static engine and adopted), deletes by its delete-rate twin (a
small batch tombstones and recomputes the affected components, a bulk
drop rebuilds the survivors). Queries run through
``connectivity.queries``, batches padded to power-of-two row counts.

**Version / invalidation protocol**: a tenant's label version is the
dynamic engine's device version counter. It ticks only when a mutation
changes the partition (a merging insert or a splitting delete), decided
on the device; neither mutation path reads it back. Cached query
results are stamped with the version they were computed at and served
only while it is unchanged: the check happens at query time, on a path
that reads back its answer anyway. An insert inside existing components
or a non-bridge delete keeps every cached answer; superseded entries age
out first-in first-out.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.connectivity import policy, queries
from repro_torch.graphs.device import DeviceGraph, resolve_device

_MAX_CACHED_RESULTS = 1024      # per tenant; FIFO-evicted


@dataclasses.dataclass
class TenantStats:
    # partition changes are not counted here: the device version counter
    # ticks exactly on merging inserts and splitting deletes, so
    # registry.stats() reports it as "partition_changes"
    inserts: int = 0
    deletes: int = 0            # delete requests
    absorbs: int = 0            # inserts routed through the incremental path
    scoped_deletes: int = 0     # deletes routed through the scoped recompute
    rebuilds: int = 0           # mutations routed through a static engine
    queries: int = 0
    cache_hits: int = 0


class TenantGraph:
    """One live graph: a ``repro_torch.api.Solver`` session (the facade
    owns routing and state; the tenant adds naming and stats)."""

    def __init__(self, name: str, num_nodes: int, *, lift_steps: int = 2,
                 policy_cache: policy.AutotuneCache | None = None,
                 device=None):
        from repro_torch.api import Solver   # the api chain imports us
        self.name = name
        self.num_nodes = num_nodes
        self.solver = Solver.open(num_nodes=num_nodes,
                                  lift_steps=lift_steps,
                                  policy_cache=policy_cache, name=name,
                                  device=device)
        self.policy_cache = policy_cache
        self.device = device
        self.stats = TenantStats()

    @property
    def inc(self):
        """The live dynamic engine (``DynamicCC``) behind the facade."""
        return self.solver.state

    @property
    def last_method(self):
        """Last policy decision (the facade records it)."""
        return self.solver.last_method

    @property
    def version(self) -> int:
        """Label version as a host int (syncs; query-path use)."""
        return self.solver.version

    @property
    def version_device(self):
        """Label version as a device scalar (no sync)."""
        return self.solver.version_device

    @property
    def labels(self):
        return self.solver.labels

    @property
    def num_edges(self) -> int:
        """Inserted-edge total (host-known, no sync): the policy's size
        feature, an upper bound on the alive count under churn."""
        return self.solver.num_edges

    def graph(self) -> DeviceGraph:
        """The surviving edge set as one compacted DeviceGraph."""
        return self.solver.graph()

    def edges(self) -> np.ndarray:
        """Host view of the surviving edges (syncs; introspection)."""
        g = self.graph()
        return queries.to_host(g.edges)[:g.true_edges]

    def _routed(self, call, arg) -> None:
        """Run a facade mutation and fold the solver's own route
        counters (taken where it decided) into the tenant stats."""
        before = dict(self.solver.stats)
        call(arg)
        after = self.solver.stats
        for field in ("inserts", "deletes", "absorbs", "scoped_deletes",
                      "rebuilds"):
            setattr(self.stats, field,
                    getattr(self.stats, field)
                    + after[field] - before[field])

    def insert(self, new_edges) -> None:
        """Insert an edge batch (DeviceGraph or host array) through the
        facade; the merge decision (version tick) is made on the device
        and not read back here."""
        self._routed(self.solver.insert, new_edges)

    def delete(self, dels) -> None:
        """Delete an edge batch (DeviceGraph or host array; each row
        retires every alive copy of that undirected edge, absent rows
        are no-ops) through the facade: a small batch tombstones and
        recomputes the affected components (the version ticks iff one
        split), a bulk drop rebuilds over the survivors."""
        self._routed(self.solver.delete, dels)


class GraphRegistry:
    """Registry of named live graphs with version-stamped query caching.
    Every tenant's session lives on ``device`` (CUDA when None; with no
    CUDA it raises unless given ``device="cpu"``)."""

    def __init__(self, *, lift_steps: int = 2,
                 policy_cache: policy.AutotuneCache | None = None,
                 device=None):
        self.lift_steps = lift_steps
        self.policy_cache = policy_cache
        self.device = resolve_device(device)
        self._tenants: dict[str, TenantGraph] = {}
        # per-tenant result cache: key -> (version, result)
        self._qcache: dict[str, dict] = {}

    # -- tenant lifecycle --------------------------------------------------

    def create(self, name: str, num_nodes: int) -> TenantGraph:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        t = TenantGraph(name, num_nodes, lift_steps=self.lift_steps,
                        policy_cache=self.policy_cache,
                        device=self.device)
        self._tenants[name] = t
        self._qcache[name] = {}
        return t

    def get(self, name: str) -> TenantGraph:
        if name not in self._tenants:
            raise KeyError(f"unknown tenant {name!r}; "
                           f"have {sorted(self._tenants)}")
        return self._tenants[name]

    def drop(self, name: str) -> None:
        self.get(name)
        del self._tenants[name]
        del self._qcache[name]

    def names(self) -> list[str]:
        return sorted(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    # -- mutation ----------------------------------------------------------

    def insert(self, name: str, edges):
        """Insert an edge batch (DeviceGraph or host array); returns the
        tenant's label version as a device scalar (``int(...)`` it to
        read it). Cached results are invalidated only if the batch
        merged components, checked lazily at query time."""
        t = self.get(name)
        t.insert(edges)
        return t.version_device

    def delete(self, name: str, edges):
        """Delete an edge batch (DeviceGraph or host array); returns the
        tenant's label version as a device scalar. Cached results are
        invalidated only if the batch split a component (a non-bridge
        delete leaves the canonical partition, and the version, as it
        was)."""
        t = self.get(name)
        t.delete(edges)
        return t.version_device

    # -- queries (cached) --------------------------------------------------

    def _cached(self, name: str, key, compute):
        t = self.get(name)
        cache = self._qcache[name]
        t.stats.queries += 1
        hit = cache.get(key)
        if hit is not None and hit[0] == t.version:
            t.stats.cache_hits += 1
            return hit[1]
        result = compute(t)
        if len(cache) >= _MAX_CACHED_RESULTS:
            cache.pop(next(iter(cache)))
        cache[key] = (t.version, result)
        return result

    def _batched_query(self, name: str, kind: str, batch: np.ndarray,
                       shape: tuple) -> np.ndarray:
        """Version-stamped cache over the facade's batch-query path (the
        bounds check, the pow2 padding and the slice live on
        ``Solver``); keyed on a content digest of the batch."""
        batch = np.asarray(batch, np.int32).reshape(shape)
        # digest, not raw bytes: keys stay O(1) even for huge batches
        digest = hashlib.blake2b(batch.tobytes(), digest_size=16).digest()
        return self._cached(
            name, (kind, batch.shape, digest),
            lambda t: getattr(t.solver, kind)(batch))

    def same_component(self, name: str, pairs) -> np.ndarray:
        """bool [Q] for an int [Q, 2] pair batch."""
        return self._batched_query(name, "same_component", pairs, (-1, 2))

    def component_size(self, name: str, vertices) -> np.ndarray:
        """int32 [Q] component sizes for a vertex batch."""
        return self._batched_query(name, "component_size", vertices,
                                   (-1,))

    def count_components(self, name: str) -> int:
        return int(self._cached(
            name, ("count_components",),
            lambda t: t.solver.num_components()))

    def component_histogram(self, name: str) -> np.ndarray:
        return queries.to_host(self._cached(
            name, ("component_histogram",),
            lambda t: t.solver.component_histogram()))

    # -- introspection -----------------------------------------------------

    def version(self, name: str) -> int:
        return self.get(name).version

    def stats(self) -> dict:
        out = {}
        for name, t in self._tenants.items():
            version = t.version            # introspection path: sync OK
            out[name] = {**dataclasses.asdict(t.stats),
                         # the version ticks exactly on merging inserts
                         # and splitting deletes: the partition changes
                         "partition_changes": version,
                         "version": version,
                         "num_nodes": t.num_nodes,
                         "num_edges": t.num_edges,
                         "num_edges_deleted": t.inc.num_edges_deleted,
                         "hook_ops": t.inc.work["hook_ops"]}
        return out
