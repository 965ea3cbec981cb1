"""Incremental and fully-dynamic connected components: the port of
``repro.core.incremental``.

``IncrementalCC`` keeps the canonical label array as live state. An
insert batch is absorbed by the shared cleanup loop
(``rounds.cleanup_rounds``) over only the new edges: hooking a new edge
merges the two stars by their min roots, the compress re-flattens, and
the loop repeats until every new edge is consistent. The state is always
at the canonical min-id fixed point, so the labels after any insert
sequence equal a from-scratch run over the accumulated edge set; a batch
that lands inside existing components costs zero hook rounds.

``DynamicCC`` adds deletions over a device ``EdgeLog``: a delete batch
tombstones the matching log rows and recomputes only the components a
retired edge touched (``rounds.scoped_rounds``), through torch ops or
the fused segment-scan kernel (``scan_method="pallas_fused"``). While
the maintained spanning forest is valid, inserts extend it and the
tree-aware delete (``delete_graph_forest``) short-circuits batches that
hit no forest edge and otherwise reconnects the split components from
the surviving forest plus crossing edges (``rounds.forest_scoped_rounds``).

Labels and the label version live on the device; the version ticks
(inside the tick's device ops) only when labels changed: a merge, or a
split. Per-batch ``WorkCounters`` queue as device tensors and fold into
host ints every ``_DRAIN_EVERY`` batches or when ``work`` is read. The
reference's ``lax.cond`` between the recompute and the no-op is a host
branch here, on whether the batch retired anything (or hit the forest);
the no-op bills zero work, as the reference's does, and the eager loops
read their conditions back from the device. ``sync_rounds`` still bills
the reference's one device program per tick. The reads are counted by
``obs.read`` (``read.drain`` and ``read.work`` for the two drains of the
work queue, ``delete_hits`` and ``tree_hits`` for the hit
classifications, the rest in ``rounds``), and a delete's phases run
under the spans ``dyn.tombstone``, ``dyn.scoped`` and
``dyn.forest.rebuild``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rounds
from repro_torch.core.rounds import WorkCounters
from repro_torch.core.segmentation import (adaptive_num_segments,
                                           plan_segmentation)
from repro_torch.graphs.device import (DeviceGraph, EdgeLog, resolve_device,
                                       validate_edge_bounds)
from repro_torch.obs import trace as obs

_DRAIN_EVERY = 256   # fold pending per-batch work into host ints
SCAN_METHODS = ("jnp", "pallas_fused")


def _bump(version: torch.Tensor, new_pi: torch.Tensor,
          pi: torch.Tensor) -> torch.Tensor:
    """The version plus one iff the labels changed (on the device)."""
    return version + (new_pi != pi).any().to(version.dtype)


class IncrementalCC:
    """Connectivity state under streaming edge insertions.

    >>> inc = IncrementalCC(num_nodes=6, device="cpu")
    >>> _ = inc.insert([[0, 1], [2, 3]])
    >>> inc.connected(0, 1)
    True
    >>> _ = inc.insert([[1, 2]])          # merges {0,1} and {2,3}
    >>> int(inc.labels[3])
    0
    """

    def __init__(self, num_nodes: int, *, lift_steps: int = 2, device=None):
        if num_nodes < 0:
            raise ValueError(f"num_nodes must be >= 0, got {num_nodes}")
        self.num_nodes = num_nodes
        self.lift_steps = lift_steps
        self.device = resolve_device(device)
        self._pi = torch.arange(num_nodes, dtype=torch.int32,
                                device=self.device)
        self.num_edges_inserted = 0
        self.batches_absorbed = 0
        self._version = torch.zeros((), dtype=torch.int32, device=self.device)
        # per-batch int64 device counters queue here unsynced and fold into
        # host ints lazily (at ``work`` or every _DRAIN_EVERY batches)
        self._work_host = {k: 0 for k in WorkCounters._fields}
        self._work_pending: list[WorkCounters] = []
        # optional on-device telemetry (``repro_torch.obs.metrics``)
        self.metrics = None

    def enable_metrics(self) -> None:
        """Attach zeroed ``Metrics`` accumulators (no-op if attached)."""
        if self.metrics is None:
            from repro_torch.obs.metrics import Metrics
            self.metrics = Metrics.zeros(self.device)

    def _record_metrics(self, kind: str, batch_work, true_count,
                        version_before) -> None:
        if self.metrics is None:
            return
        from repro_torch.obs import metrics as obs_metrics
        self.metrics = obs_metrics.record_mutation(
            self.metrics, batch_work, true_count, version_before,
            self._version, kind=kind)

    @property
    def labels(self) -> torch.Tensor:
        """Canonical min-id labels, [num_nodes] int32."""
        return self._pi

    @property
    def version(self) -> int:
        """Label version as a host int (syncs; see ``version_device``)."""
        return int(self._version)

    @property
    def version_device(self) -> torch.Tensor:
        """Label version as an int32 0-d device tensor (no sync)."""
        return self._version

    def _drain_work(self, site: str) -> None:
        """Fold the queued counters into host ints: one read, counted
        under ``read.<site>``."""
        if self._work_pending:
            stacked = torch.stack([torch.stack(list(w))
                                   for w in self._work_pending])
            stacked = obs.read(site, lambda: stacked.cpu())
            for k, col in zip(WorkCounters._fields, stacked.T.tolist()):
                self._work_host[k] += sum(col)
        self._work_pending.clear()

    def _queue_work(self, work: WorkCounters | dict | None) -> None:
        if work is None:
            return
        if isinstance(work, WorkCounters):
            self._work_pending.append(work)
        else:
            for k, v in work.items():
                self._work_host[k] += int(v)
        if len(self._work_pending) >= _DRAIN_EVERY:
            self._drain_work("drain")    # rare amortized sync point

    @property
    def work(self) -> dict:
        """Accumulated work counters as host ints (syncs on access)."""
        self._drain_work("work")
        return dict(self._work_host)

    def _absorb(self, edges: torch.Tensor, true: int) -> None:
        """One absorb: the cleanup loop over the batch's true rows (the
        reference hooks its pow2-padded block; (0, 0) padding is a no-op
        over a compressed π, so the result and billing are the same),
        the version tick and the batch's work."""
        v0, true_count = self._version, torch.tensor(
            true, dtype=torch.int32, device=self.device)
        new_pi, work = rounds.cleanup_rounds(
            self._pi, edges[:true], rounds.torch_round_ops(self.lift_steps),
            WorkCounters.zeros(self.device), true_edges=true)
        work = work.add(sync_rounds=1)
        self._version = _bump(self._version, new_pi, self._pi)
        self._pi = new_pi
        self._queue_work(work)
        self._record_metrics("insert", work, true_count, v0)

    def insert(self, new_edges) -> torch.Tensor:
        """Absorb a host-array batch of edge insertions; returns the new
        labels. Self loops, duplicates and already-connected edges are
        harmless (the latter cost zero hook rounds)."""
        new_edges = np.ascontiguousarray(new_edges, np.int32).reshape(-1, 2)
        validate_edge_bounds(new_edges, self.num_nodes)
        e = new_edges.shape[0]
        self.num_edges_inserted += e
        self.batches_absorbed += 1
        if e == 0 or self.num_nodes == 0:
            return self._pi
        self._absorb(torch.from_numpy(new_edges).to(self.device), e)
        return self._pi

    def insert_graph(self, delta: DeviceGraph) -> torch.Tensor:
        """Absorb a ``DeviceGraph`` insert batch. Bounds are not
        re-checked (the API boundary validates host inputs)."""
        if delta.num_nodes != self.num_nodes:
            raise ValueError(f"delta num_nodes {delta.num_nodes} != "
                             f"{self.num_nodes}")
        self.num_edges_inserted += delta.num_edges
        self.batches_absorbed += 1
        if self.num_nodes == 0 or delta.edges.shape[0] == 0:
            return self._pi
        self._absorb(delta.edges, delta.true_edges)
        return self._pi

    def adopt(self, labels, work=None, num_edges: int = 0) -> torch.Tensor:
        """Adopt externally computed canonical labels as the new state
        (the bulk-load route: a static engine ran instead of the
        absorb). Bills ``work`` (``WorkCounters`` or a field dict) and
        ticks the version iff the labels changed."""
        labels = torch.as_tensor(labels, device=self.device).to(torch.int32)
        if tuple(labels.shape) != (self.num_nodes,):
            raise ValueError(f"labels shape {tuple(labels.shape)} != "
                             f"({self.num_nodes},)")
        self.num_edges_inserted += int(num_edges)
        self.batches_absorbed += 1
        self._queue_work(work)
        if self.num_nodes == 0:
            return self._pi
        self._version = _bump(self._version, labels, self._pi)
        self._pi = labels
        if self.metrics is not None:
            from repro_torch.obs import metrics as obs_metrics
            self.metrics = obs_metrics.record_rebuild(self.metrics)
        return self._pi

    def connected(self, u: int, v: int) -> bool:
        for x in (u, v):
            if not 0 <= x < self.num_nodes:
                raise ValueError(f"vertex {x} out of range "
                                 f"[0, {self.num_nodes})")
        return int(self._pi[u]) == int(self._pi[v])

    def num_components(self) -> int:
        """Component count (one device sort and boundary count)."""
        from repro_torch.connectivity.queries import count_components
        return int(count_components(self._pi))


class DynamicCC(IncrementalCC):
    """Fully-dynamic connectivity: streaming insertions and deletions
    over one device-resident state.

    The accumulated edge set lives in an ``EdgeLog``. Inserts append to
    it and absorb; a delete batch tombstones matching rows and runs a
    scoped recompute over only the components a retired edge touched.
    A deletion that is not a bridge reproduces the same canonical
    partition, so the version ticks only on an actual split.

    Deletion semantics: a delete of undirected edge {u, v} is
    orientation-blind and retires every alive copy; deleting an absent
    edge is a zero-cost no-op. After any insert / delete script the
    labels equal a from-scratch run over the surviving edges.

    ``scan_method`` picks the scoped recompute's backend: ``"jnp"``
    (torch ops, named as in the reference) or ``"pallas_fused"`` (the
    fused segment-scan kernel, one launch per scan and per cleanup
    round).

    >>> dyn = DynamicCC(num_nodes=4, device="cpu")
    >>> _ = dyn.insert([[0, 1], [1, 2]])
    >>> _ = dyn.delete([[1, 2]])
    >>> dyn.connected(0, 1), dyn.connected(1, 2)
    (True, False)
    """

    def __init__(self, num_nodes: int, *, lift_steps: int = 2,
                 scan_method: str = "jnp", device=None):
        super().__init__(num_nodes, lift_steps=lift_steps, device=device)
        if scan_method not in SCAN_METHODS:
            raise ValueError(f"unknown scan_method {scan_method!r}; "
                             f"choose from {SCAN_METHODS}")
        self.scan_method = scan_method
        self.log = EdgeLog(num_nodes, device=self.device)
        self.delete_batches = 0
        self._deleted = torch.zeros((), dtype=torch.int32, device=self.device)
        # the maintained spanning forest: parent edges and the log row
        # each was recorded from. ``_forest_valid`` is a host flag: bulk
        # routes (adopt, tombstone-only deletes, the plain scoped delete)
        # change labels or the log without maintaining the forest, and
        # the next forest-routed delete rebuilds it
        self._parents = rounds.empty_forest(num_nodes, self.device)
        self._parent_eidx = rounds.empty_forest_idx(num_nodes, self.device)
        self._forest_valid = True
        # [nontree_shortcircuit, tree_scoped] on the device, plus the host
        # rebuild count; drained into obs by delete_route_counts()
        self._delete_routes = torch.zeros(2, dtype=torch.int32,
                                          device=self.device)
        self.forest_rebuilds = 0
        self._routes_flushed = {"nontree_shortcircuit": 0,
                                "tree_scoped": 0, "rebuild": 0}

    # -- inserts ----------------------------------------------------------

    def _coerce(self, edges) -> DeviceGraph:
        arr = np.asarray(edges, np.int32).reshape(-1, 2)
        validate_edge_bounds(arr, self.num_nodes)
        return DeviceGraph.from_edges(arr, self.num_nodes,
                                      device=self.device)

    def insert(self, new_edges) -> torch.Tensor:
        """Absorb a host-array insert batch (validated, copied, logged)."""
        return self.insert_graph(self._coerce(new_edges))

    def insert_graph(self, delta: DeviceGraph) -> torch.Tensor:
        """Append the delta's true rows to the log, then absorb. While the
        maintained forest is valid the absorb also records each winning
        hook's edge and log row (labels and version as the plain
        absorb's), so inserts never stale the forest."""
        rows_before = self.log.rows
        self.log.append(delta)          # validates |V|
        if not self._forest_valid:
            return super().insert_graph(delta)
        self.num_edges_inserted += delta.num_edges
        self.batches_absorbed += 1
        if self.num_nodes == 0 or delta.edges.shape[0] == 0:
            return self._pi
        t = delta.true_edges
        v0 = self._version
        true_count = torch.tensor(t, dtype=torch.int32, device=self.device)
        eids = torch.arange(rows_before, rows_before + t, dtype=torch.int32,
                            device=self.device)
        ops = rounds.forest_round_ops(self._parents, self._parent_eidx,
                                      lift_steps=self.lift_steps)
        new_pi, work = rounds.cleanup_rounds(
            self._pi, delta.edges, ops, WorkCounters.zeros(self.device),
            true_edges=t, edge_ids=eids)
        self._parents, self._parent_eidx = ops.tables()
        work = work.add(sync_rounds=1)
        self._version = _bump(self._version, new_pi, self._pi)
        self._pi = new_pi
        self._queue_work(work)
        self._record_metrics("insert", work, true_count, v0)
        return self._pi

    def stage(self, delta: DeviceGraph) -> None:
        """Append a delta to the log without absorbing (the bulk-rebuild
        route: a static engine recomputes over ``graph()`` and the
        caller ``adopt``s the result)."""
        self.log.append(delta)

    def adopt(self, labels, work=None, num_edges: int = 0) -> torch.Tensor:
        """``IncrementalCC.adopt``, and the maintained forest goes stale
        until the next forest-routed delete rebuilds it."""
        self._forest_valid = False
        return super().adopt(labels, work=work, num_edges=num_edges)

    # -- deletes ----------------------------------------------------------

    def _check_dels(self, dels: DeviceGraph) -> bool:
        """Count the batch; False when there is nothing to do."""
        if dels.num_nodes != self.num_nodes:
            raise ValueError(f"dels num_nodes {dels.num_nodes} != "
                             f"{self.num_nodes}")
        self.delete_batches += 1
        return not (self.num_nodes == 0 or dels.edges.shape[0] == 0
                    or self.log.rows == 0)

    def _tombstone(self, dels: DeviceGraph) -> torch.Tensor:
        """Tombstone the batch against the log and count what died;
        returns the killed mask."""
        killed = self.log.delete(dels.edges, dels.true_edges)
        self._deleted = self._deleted + killed.sum(dtype=torch.int32)
        return killed

    def _affected(self, pi: torch.Tensor, hit_labels: torch.Tensor
                  ) -> torch.Tensor:
        """bool [V]: the vertices whose component label is among
        ``hit_labels``. The reference max-scatters a flag over every
        log row (or vertex), nearly all of which hit one giant
        component's label; only the hit rows write here."""
        aff = torch.zeros(self.num_nodes, dtype=torch.bool,
                          device=self.device)
        aff[hit_labels.long()] = True
        return aff[pi.long()]

    def delete(self, edges) -> torch.Tensor:
        """Delete a host-array edge batch; returns the new labels."""
        return self.delete_graph(self._coerce(edges))

    def delete_graph(self, dels: DeviceGraph) -> torch.Tensor:
        """The scoped delete tick: tombstone the batch, and if it retired
        anything, recompute the affected components over their surviving
        edges (``scan_method`` picks torch ops or the fused kernel). The
        version ticks iff a component split."""
        if not self._check_dels(dels):
            return self._pi
        edges, pi = self.log.edges, self._pi
        v0, true_count = self._version, dels.true_edges_device()
        with obs.span("dyn.tombstone"):
            killed = self._tombstone(dels)
            hit = obs.read("delete_hits",
                           lambda: killed.nonzero()).squeeze(1)
        if hit.shape[0]:
            # both endpoints of an alive edge share a label, so marking
            # pi[u] covers pi[v]
            in_aff = self._affected(pi, pi[edges[hit, 0].long()])
            edge_aff = self.log.alive & in_aff[edges[:, 0].long()]
            n_aff = in_aff.sum(dtype=torch.int32)
            ops = rounds.fused_round_ops(self.lift_steps, bill_nodes=n_aff) \
                if self.scan_method == "pallas_fused" \
                else rounds.torch_round_ops(self.lift_steps,
                                            bill_nodes=n_aff)
            plan = plan_segmentation(
                self.log.capacity, self.num_nodes,
                adaptive_num_segments(self.log.capacity, self.num_nodes))
            with obs.span("dyn.scoped"):
                pi1, work = rounds.scoped_rounds(
                    pi, edges, edge_aff, in_aff, plan, ops,
                    WorkCounters.zeros(self.device))
            self._version = _bump(self._version, pi1, pi)
            self._pi = pi1
        else:
            # nothing retired (unknown edges, double deletes): zero work
            work = WorkCounters.zeros(self.device)
        work = work.add(sync_rounds=1)
        # the plain scoped recompute does not maintain parent edges
        self._forest_valid = False
        self._queue_work(work)
        self._record_metrics("delete", work, true_count, v0)
        return self._pi

    def ensure_forest(self) -> None:
        """Re-derive the maintained forest from the surviving log if a
        bulk route staled it: ``rounds.forest_scan_rounds_ids`` over the
        packed alive rows, in the adaptive plan's segments. Its labels
        are canonical and equal the live state's, so the version does
        not tick. Counts into ``dynamic.deletes.rebuild``; its span's
        ``loop`` tag says where the scan's sweeps run
        (``rounds.forest_scan_loop``)."""
        if self._forest_valid:
            return
        with obs.span("dyn.forest.rebuild") as sp:
            dev, n = self.device, self.num_nodes
            edges, alive = self.log.edges, self.log.alive
            e = edges.shape[0]
            packed, pids, true = rounds.pack_edge_rows(
                edges, torch.arange(e, dtype=torch.int32, device=dev), alive)
            plan = plan_segmentation(e, n, adaptive_num_segments(e, n))
            pi, parents, eidx, work = rounds.forest_scan_rounds_ids(
                torch.arange(n, dtype=torch.int32, device=dev),
                rounds.empty_forest(n, dev), rounds.empty_forest_idx(n, dev),
                packed, pids, true, WorkCounters.zeros(dev),
                lift_steps=self.lift_steps, segment_size=plan.segment_size,
                num_segments=plan.num_segments, span=sp)
            self._pi, self._parents, self._parent_eidx = pi, parents, eidx
            self._queue_work(work.add(sync_rounds=1))
        self._forest_valid = True
        self.forest_rebuilds += 1
        obs.count("dynamic.deletes.rebuild")

    def delete_graph_forest(self, dels: DeviceGraph) -> torch.Tensor:
        """The tree-aware delete tick: tombstone the batch, classify tree
        and non-tree hits against the maintained forest (vertex r lost
        its tree edge iff its recorded log row just died), leave labels,
        forest and version untouched when no tree edge died (zero hook
        work), and otherwise reconnect only the components that lost a
        tree edge, from the surviving forest and the crossing edges.
        Rebuilds a stale forest first (``ensure_forest``)."""
        if not self._check_dels(dels):
            return self._pi
        self.ensure_forest()
        edges, pi = self.log.edges, self._pi
        v0, true_count = self._version, dels.true_edges_device()
        with obs.span("dyn.tombstone"):
            killed = self._tombstone(dels)
            has_parent = self._parent_eidx >= 0
            safe = self._parent_eidx.clamp(min=0).long()
            tree_hit = has_parent & killed[safe]
            hit = obs.read("tree_hits",
                           lambda: tree_hit.nonzero()).squeeze(1)
        any_hit = hit.shape[0] > 0
        if any_hit:
            in_aff = self._affected(pi, pi[hit])
            edge_aff = self.log.alive & in_aff[edges[:, 0].long()]
            forest_keep = in_aff & has_parent & ~killed[safe]
            eids = torch.arange(edges.shape[0], dtype=torch.int32,
                                device=self.device)
            pi1, self._parents, self._parent_eidx, work = \
                rounds.forest_scoped_rounds(
                    pi, self._parents, self._parent_eidx, edges, eids,
                    edge_aff, forest_keep, in_aff,
                    WorkCounters.zeros(self.device))
            self._version = _bump(self._version, pi1, pi)
            self._pi = pi1
        else:
            work = WorkCounters.zeros(self.device)
        work = work.add(sync_rounds=1)
        self._delete_routes[int(any_hit)] += 1
        self._queue_work(work)
        self._record_metrics("delete", work, true_count, v0)
        return self._pi

    def tombstone_graph(self, dels: DeviceGraph) -> None:
        """Tombstone a delete batch without the scoped recompute (the
        bulk-delete route: the caller rebuilds through a static engine
        and ``adopt``s, whose label diff supplies the split tick)."""
        if not self._check_dels(dels):
            return
        self._tombstone(dels)
        self._forest_valid = False

    def compact(self) -> None:
        """Compact the log in place and remap the maintained forest's
        ``parent_eidx`` through the compaction permutation (the two must
        move together, or every forest pointer names the wrong row).
        One read back, for the cursor."""
        perm = self.log.compact()
        if self._forest_valid:
            safe = self._parent_eidx.clamp(min=0).long()
            self._parent_eidx = torch.where(self._parent_eidx >= 0,
                                            perm[safe], -1)

    # -- views / introspection ---------------------------------------------

    @property
    def forest(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(parents [V, 2], parent_eidx [V]): the maintained spanning
        forest (-1 rows are component roots). Check ``forest_valid`` (or
        call ``ensure_forest()``) first if a bulk route may have staled
        it."""
        return self._parents, self._parent_eidx

    @property
    def forest_valid(self) -> bool:
        return self._forest_valid

    def delete_route_counts(self, flush_obs: bool = True) -> dict:
        """Read the delete-route telemetry back (an introspection point,
        never on the tick) and, unless told otherwise, fold the deltas
        into the host obs counters
        ``dynamic.deletes.{nontree_shortcircuit,tree_scoped}``."""
        vals = self._delete_routes.tolist()
        counts = {"nontree_shortcircuit": int(vals[0]),
                  "tree_scoped": int(vals[1]),
                  "rebuild": self.forest_rebuilds}
        if flush_obs:
            for k in ("nontree_shortcircuit", "tree_scoped"):
                delta = counts[k] - self._routes_flushed[k]
                if delta:
                    obs.count(f"dynamic.deletes.{k}", delta)
                self._routes_flushed[k] = counts[k]
        return counts

    def graph(self) -> DeviceGraph:
        """The surviving edge set as a compacted ``DeviceGraph`` (what
        the bulk-rebuild route feeds to the static engines)."""
        return self.log.view()

    @property
    def num_edges_deleted(self) -> int:
        """Retired-edge count as a host int (syncs; introspection)."""
        return int(self._deleted)

    @property
    def num_edges_alive(self) -> int:
        """Surviving-edge count (syncs; introspection)."""
        return self.log.num_alive
