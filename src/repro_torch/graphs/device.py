"""DeviceGraph and EdgeLog — the device-resident graph substrate.

The port of ``repro.graphs.device``. A ``DeviceGraph`` is what the
static solves consume:

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

``shard(mesh, axis_names)`` splits a graph's rows over a ``Mesh``'s
slots, one contiguous tensor per slot on that slot's device
(``shards``): what the multi-shard engine (``core.distributed``)
consumes.

An ``EdgeLog`` is the fully-dynamic engine's edge set: an append /
tombstone log on the device whose capacity grows by powers of two
(``append``, ``delete``, ``view``, ``compact``).

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
_INT32_LIMIT = 2**31


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


def check_shard_extent(rows: int, num_nodes: int) -> None:
    """Raise ``ValueError`` unless ``rows`` edge rows and ``num_nodes``
    vertices index within int32: the engines address both with 32-bit
    ids and must not wrap around."""
    for what, n in (("rows", rows), ("|V|", num_nodes)):
        if n >= _INT32_LIMIT:
            raise ValueError(f"{what} = {n} does not fit int32: the "
                             "sharded graph is too large")


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
                 name: str = "graph", degree_skew: float | None = None,
                 count_on_device: bool = False, shards: tuple | None = None):
        self.edges = edges                     # int32 [E, 2]
        self.num_nodes = int(num_nodes)
        self.true_edges = int(true_edges)
        self.plan = plan
        self.name = name
        # max_degree / mean_degree, measured at host ingest (None when
        # the edges arrived as a tensor already)
        self.degree_skew = degree_skew
        # True for ``EdgeLog.view()``: the reference holds this count on
        # the device only, so its engines run even over zero true edges
        # (and bill their fixed rounds) instead of returning early
        self.count_on_device = count_on_device
        # ``shard()``'s split of ``edges``: one [E / n, 2] tensor per mesh
        # slot, on that slot's device, in slot order (None: unsharded)
        self.shards = shards

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
            host = np.ascontiguousarray(edges, np.int32).reshape(-1, 2)
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

    def true_edges_device(self) -> torch.Tensor:
        """The true edge count as an int32 0-d tensor on the graph's
        device."""
        return torch.tensor(self.true_edges, dtype=torch.int32,
                            device=self.device)

    @property
    def is_empty(self) -> bool:
        """True when an engine has nothing to run: no stored rows, or a
        host-known true count of zero."""
        return self.edges.shape[0] == 0 or (self.true_edges == 0
                                            and not self.count_on_device)

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

    def shard(self, mesh, axis_names=("data",)) -> "DeviceGraph":
        """Split the edge list over the mesh's ``axis_names``: pad with
        (0, 0) no-ops to ``per * n`` rows (``per = max(1, ceil(E / n))``,
        ``n`` the slot count) so that any row count splits evenly, then
        give each slot its contiguous ``per`` rows on its own device
        (``shards``; a slot on the graph's device gets a view, not a
        copy). ``edges`` stays the padded whole on the graph's device."""
        slots = mesh.slot_devices(axis_names)
        n = len(slots)
        per = max(1, -(-int(self.edges.shape[0]) // n))
        check_shard_extent(per * n, self.num_nodes)
        padded = self.pad_rows(per * n)
        parts = tuple(padded.edges[i * per:(i + 1) * per].to(d)
                      for i, d in enumerate(slots))
        return DeviceGraph(padded.edges, self.num_nodes, padded.true_edges,
                           padded.plan, name=self.name,
                           degree_skew=self.degree_skew,
                           count_on_device=self.count_on_device,
                           shards=parts)

    @classmethod
    def concat(cls, graphs, name: str | None = None) -> "DeviceGraph":
        """Concatenate same-|V| graphs on their device (the service's
        coalescing primitive). Every part needs a host-known true count:
        a part whose count lives on the device (an ``EdgeLog`` view) is
        refused, since its padding would land inside the result where
        the engines read it as real edges. Padded parts are trimmed to
        their true rows first, so the result keeps the prefix invariant.

        ``degree_skew`` joins by the max of the parts' known values and
        stays None when no part has one: a dropped skew would flip
        ``method="auto"`` mid-session."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError("concat needs at least one DeviceGraph")
        if len({g.num_nodes for g in graphs}) != 1:
            raise ValueError("concat requires identical num_nodes, got "
                             f"{[g.num_nodes for g in graphs]}")
        if len(graphs) == 1:
            return graphs[0]
        if any(g.count_on_device for g in graphs):
            raise ValueError(
                "concat needs static true_edges on every part "
                "(prefix-padding invariant)")
        edges = torch.cat([g.edges[:g.true_edges] for g in graphs], dim=0)
        true = sum(g.true_edges for g in graphs)
        plan = _plan_for(int(edges.shape[0]), graphs[0].num_nodes, true,
                         None)
        skews = [g.degree_skew for g in graphs if g.degree_skew is not None]
        return cls(edges, graphs[0].num_nodes, true, plan,
                   name=name or graphs[0].name,
                   degree_skew=max(skews) if skews else None)

    def __repr__(self) -> str:
        t = self.true_edges
        return (f"DeviceGraph(|V|={self.num_nodes}, "
                f"|E|={self.edges.shape[0]}"
                + (f", true={t}" if t != self.edges.shape[0] else "")
                + f", s={self.plan.num_segments}, name={self.name!r}, "
                f"device={self.device})")


# ---------------------------------------------------------------------------
# EdgeLog — the fully-dynamic edge substrate
# ---------------------------------------------------------------------------

def _pair_keys(pairs: torch.Tensor) -> torch.Tensor:
    """int64 key per row of an int [N, 2] pair array, equal for (u, v)
    and (v, u): ``min << 32 | max``. Ids are int32 >= 0, so the key
    orders rows as the (min, max) pair does and never overflows."""
    lo = torch.minimum(pairs[:, 0], pairs[:, 1]).long()
    hi = torch.maximum(pairs[:, 0], pairs[:, 1]).long()
    return (lo << 32) | hi


def undirected_group_ids(pairs: torch.Tensor) -> torch.Tensor:
    """int32 [N] group id per row of an int [N, 2] pair array; two rows
    get the same id iff they denote the same undirected edge. Ids count
    the distinct (min, max) pairs in ascending order, as the
    reference's. The reference sorts twice on int32 keys (its ``min *
    |V| + max`` would overflow int32); one stable sort on the int64 key
    gives the same order."""
    n = pairs.shape[0]
    order = torch.sort(_pair_keys(pairs), stable=True)
    new_group = torch.zeros(n, dtype=torch.int32, device=pairs.device)
    new_group[1:] = (order.values[1:] != order.values[:-1]).to(torch.int32)
    gid_sorted = torch.cumsum(new_group, 0, dtype=torch.int32)
    return torch.zeros(n, dtype=torch.int32, device=pairs.device) \
        .index_put_((order.indices,), gid_sorted)


def tombstone_mask(edges: torch.Tensor, alive: torch.Tensor,
                   dels: torch.Tensor, d_true
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply a delete batch to an alive mask. A delete of undirected edge
    {u, v} is orientation-blind and kills every alive copy (duplicates
    die together). Rows of ``dels`` at index >= ``d_true`` (an int or a
    0-d tensor) are padding and match nothing. Returns ``(new_alive,
    killed)``, ``killed`` marking the log rows this batch retired.

    The reference group-ids the log and the batch together (one sort of
    E + D rows). Here only the D delete keys are sorted, and each log
    row looks its key up in them: the same matches, in one pass over
    the log and no sort of it."""
    d = dels.shape[0]
    if d == 0 or edges.shape[0] == 0:
        return alive, torch.zeros_like(alive)
    real = torch.arange(d, device=dels.device) < d_true
    # padding keys are -1, which no log row's key equals
    keys = torch.sort(torch.where(real, _pair_keys(dels), -1)).values
    log_keys = _pair_keys(edges)
    pos = torch.searchsorted(keys, log_keys).clamp_(max=d - 1)
    killed = (keys[pos] == log_keys) & alive
    return alive & ~killed, killed


def compact_alive_perm(edges: torch.Tensor, alive: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather the alive rows, in order, to a (0, 0)-padded prefix.
    Returns ``(packed, true_count, perm)``: ``true_count`` an int32 0-d
    tensor, ``perm[i]`` the compacted position of old row ``i`` or -1
    if the row was dead (holders of log-row indices, the maintained
    forest's ``parent_eidx``, remap through it)."""
    idx = alive.nonzero().squeeze(1)
    n = idx.shape[0]
    packed = torch.zeros_like(edges)
    packed[:n] = edges[idx]
    perm = torch.full((alive.shape[0],), -1, dtype=torch.int32,
                      device=alive.device)
    perm[idx] = torch.arange(n, dtype=torch.int32, device=alive.device)
    return packed, torch.tensor(n, dtype=torch.int32,
                                device=alive.device), perm


def compact_alive(edges: torch.Tensor, alive: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``compact_alive_perm`` without the permutation: ``(packed,
    true_count)``. Restores the prefix-padding invariant the engines
    rely on."""
    packed, true, _ = compact_alive_perm(edges, alive)
    return packed, true


class EdgeLog:
    """Device-resident append / tombstone edge log: the substrate of
    fully-dynamic connectivity.

    * ``edges`` int32 [cap, 2]; rows past the append cursor ``rows``
      are (0, 0) and dead;
    * ``alive`` bool [cap], the tombstone mask: inserts set it, deletes
      clear it;
    * capacity grows by powers of two and leaves headroom for each
      append's pow2-padded block, exactly as the reference's does, so
      the scoped delete segments the same capacity
      (``adaptive_num_segments(capacity, |V|)``) and bills the same
      work.

    Deletes tombstone and do not compact; ``compact()`` packs the alive
    rows to the prefix on demand, ``view()`` returns them as a
    ``DeviceGraph``.
    """

    def __init__(self, num_nodes: int, *, capacity: int = 64, device=None):
        self.num_nodes = int(num_nodes)
        dev = resolve_device(device)
        cap = next_pow2(max(capacity, 8))
        self.edges = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
        self.alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.rows = 0                   # host append cursor

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @property
    def capacity(self) -> int:
        return int(self.edges.shape[0])

    def num_alive_device(self) -> torch.Tensor:
        """Alive edge count as an int32 0-d tensor (no sync)."""
        return self.alive.sum(dtype=torch.int32)

    @property
    def num_alive(self) -> int:
        """Alive edge count (syncs; introspection only)."""
        return int(self.num_alive_device())

    def _grow(self, target: int) -> None:
        pad = target - self.capacity
        self.edges = torch.cat([self.edges, self.edges.new_zeros((pad, 2))])
        self.alive = torch.cat([self.alive, self.alive.new_zeros((pad,))])

    def append(self, delta: DeviceGraph) -> None:
        """Append a delta's true rows. The write is a pow2-padded block
        (at least ``_MIN_PAD_ROWS`` rows) whose tail is scrubbed to dead
        (0, 0) rows; capacity grows to the next power of two that holds
        the block, and the cursor advances by the true count (the next
        append overwrites the dead tail)."""
        if delta.num_nodes != self.num_nodes:
            raise ValueError(f"delta num_nodes {delta.num_nodes} != "
                             f"{self.num_nodes}")
        t = delta.true_edges
        if t == 0:
            return
        p = next_pow2(max(t, _MIN_PAD_ROWS))
        if self.rows + p > self.capacity:     # headroom for the block
            self._grow(next_pow2(self.rows + p))
        r = self.rows
        self.edges[r:r + t] = delta.edges[:t].to(self.device)
        self.edges[r + t:r + p] = 0
        self.alive[r:r + t] = True
        self.alive[r + t:r + p] = False
        self.rows += t

    def delete(self, dels: torch.Tensor, d_true) -> torch.Tensor:
        """Tombstone a delete batch (the bulk-rebuild delete route; the
        scoped routes tombstone inside their own tick). Returns the
        killed mask (never synced here)."""
        self.alive, killed = tombstone_mask(self.edges, self.alive,
                                            dels, d_true)
        return killed

    def view(self) -> DeviceGraph:
        """The alive edge set as a compacted ``DeviceGraph``: what the
        bulk-rebuild route feeds to the static engines. The reference
        keeps the alive count on the device and so plans the stored
        capacity with s = ``adaptive_num_segments(capacity, |V|)``;
        this view plans the same. The count itself is read back once
        here, since the port's ``DeviceGraph`` holds a host count: a
        bulk route, not a tick."""
        packed, true = compact_alive(self.edges, self.alive)
        cap = self.capacity
        plan = plan_segmentation(cap, self.num_nodes,
                                 adaptive_num_segments(cap, self.num_nodes))
        return DeviceGraph(packed, self.num_nodes, int(true), plan,
                           name="log", count_on_device=True)

    def compact(self) -> torch.Tensor:
        """Compact in place: pack the alive rows to the prefix, scrub the
        tail and pull the cursor back to the alive count (one read
        back, for the cursor). Returns the old-to-new row permutation
        (int32 [cap], -1 for retired rows)."""
        self.edges, true, perm = compact_alive_perm(self.edges, self.alive)
        self.rows = int(true)
        self.alive = torch.arange(self.capacity,
                                  device=self.device) < self.rows
        return perm

    def __repr__(self) -> str:
        return (f"EdgeLog(|V|={self.num_nodes}, cap={self.capacity}, "
                f"rows={self.rows})")


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
                               degree_skew=graph.degree_skew,
                               count_on_device=graph.count_on_device)
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
