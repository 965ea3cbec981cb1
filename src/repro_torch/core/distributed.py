"""Multi-shard connected components: the port of
``repro.core.distributed``.

The paper's segmentation taken across devices (DESIGN.md §5):

  * the edges are split over a ``Mesh``'s slots (``DeviceGraph.shard``),
    each slot owning a contiguous partition on its own device;
  * the parent array π (the |V| workspace) is replicated, one copy per
    device;
  * each round every slot runs the Fig. 4 segment scan over its own
    partition (hook with a bounded root chase, then compress, segment by
    segment), the slots' π are merged by an elementwise MIN (``pmin``:
    valid because scatter-min updates only lower π, so the min of the
    per-slot results is the result of hooking the union), and the merged
    π is compressed to its fixpoint;
  * the round ends with every slot checking its own edges against the
    merged π; the loop stops when all are consistent or after
    ``_MAX_ROUNDS`` rounds, exactly as the reference does.

The reference is one ``shard_map`` inside one ``jax.jit``, its loop a
device-side ``while_loop``. Here one host process drives every slot
(single-controller, as the reference is), and the loop's condition is
ONE flag read back per round: the slots' checks are ANDed on the device
and read once. On a CUDA slot the scan is the fused segment-scan kernel
(K1, one launch per slot per round) and the compress the multi_jump
kernel's fixpoint body (K3, one launch per device per round); on the CPU
they are the torch-op scan (the reference's ``jnp_round_ops``) and
``rounds.compress``. Both compresses reach the same fixpoint: the merged
π is a forest whose pointers only go down (every entry is a min of
labels at most its own id), and pointer jumping on a forest has one
fixpoint.

The merge is behind one function, ``pmin``: on one device an on-device
``torch.minimum`` over the slots; across devices a copy to slot 0's
device, the min there, and a copy back to every other device. An NCCL
``all_reduce(MIN)`` can take its place once a run spans processes.

Scale posture, as the reference's: the replicated π costs |V| * 4 bytes
per device. Row counts and |V| must index within int32
(``check_shard_extent``).
"""
from __future__ import annotations

import torch

from repro_torch.core import rounds
from repro_torch.core.rounds import WorkCounters
from repro_torch.core.segmentation import plan_segmentation
from repro_torch.graphs.device import (DeviceGraph, as_device_graph,
                                       check_shard_extent)

# Global merge rounds to convergence on the Table I graph classes: 2-4
# (the reference's EXPERIMENTS.md); 8 is its 2x margin.
_MAX_ROUNDS = 8


def _replicate(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """``t`` on each of ``devices``, one copy per distinct device (slots
    on one device share one tensor)."""
    copies = {t.device: t}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d)
        out.append(copies[d])
    return out


def pmin(pis) -> list[torch.Tensor]:
    """The merge of a round: the elementwise min of the slots' π, on
    every slot's device. On one device this is ``torch.minimum`` over
    the slots; across devices the slots' π are copied to slot 0's
    device, reduced there and the result copied back. Slots on one
    device share the returned tensor."""
    merged = pis[0]
    for p in pis[1:]:
        merged = torch.minimum(merged, p.to(merged.device))
    return _replicate(merged, [p.device for p in pis])


def _compress(pi: torch.Tensor) -> torch.Tensor:
    """Compress to the fixpoint: K3's fixpoint body on a CUDA π, the
    Jacobi sweeps of ``rounds.compress`` on the CPU."""
    if pi.device.type == "cuda":
        from repro_torch.kernels.multi_jump.ops import full_compress
        return full_compress(pi)
    return rounds.compress(pi, WorkCounters.zeros(pi.device))[0]


def _round_ops(device: torch.device, lift_steps: int) -> rounds.RoundOps:
    if device.type == "cuda":
        return rounds.fused_round_ops(lift_steps)
    return rounds.torch_round_ops(lift_steps)


class DistributedCC:
    """The multi-shard engine for one (rows, |V|) shape, built by
    ``build_distributed_cc``. Call it on a sharded ``DeviceGraph``
    (``graph.shard(mesh, axis_names)``; an unsharded one of the same row
    count is sharded first), or ``on_edges`` on the padded [rows, 2]
    edge tensor. Returns canonical labels [V] on slot 0's device.
    ``last_rounds`` holds the rounds the last call ran (at most
    ``_MAX_ROUNDS``)."""

    def __init__(self, num_nodes: int, rows: int, mesh, axis_names,
                 lift_steps: int, local_segments: int | None):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.slots = mesh.slot_devices(self.axis_names)
        n_shards = len(self.slots)
        if rows % n_shards:
            raise ValueError(
                f"edge count {rows} does not divide into {n_shards} shards; "
                "shard the graph with DeviceGraph.shard(mesh, axis_names)")
        check_shard_extent(rows, num_nodes)
        self.num_nodes = int(num_nodes)
        self.rows = rows
        self.edges_per_shard = per = rows // n_shards
        segs = local_segments or plan_segmentation(per, num_nodes).num_segments
        segs = max(1, min(segs, per))
        # the per-slot plan; the scan pads each partition with (0, 0)
        # no-ops to the plan's rows and bills every row as true (the
        # padding hooks vertex 0 to itself)
        self.plan = plan_segmentation(per, num_nodes, segs)
        self.lift_steps = lift_steps
        self.last_rounds = 0

    def __call__(self, graph) -> torch.Tensor:
        g = graph if isinstance(graph, DeviceGraph) else as_device_graph(
            graph, self.num_nodes, device=self.slots[0])
        if g.shards is not None and len(g.shards) == len(self.slots) \
                and int(g.edges.shape[0]) == self.rows:
            return self._run(g.shards)
        return self.on_edges(g.edges)

    def on_edges(self, edges: torch.Tensor) -> torch.Tensor:
        """Labels for a padded [rows, 2] edge tensor: split into the
        slots' contiguous partitions, each moved to its slot's device."""
        if int(edges.shape[0]) != self.rows:
            raise ValueError(f"the engine was built for {self.rows} rows, "
                             f"got {int(edges.shape[0])}")
        per = self.edges_per_shard
        return self._run([edges[i * per:(i + 1) * per].to(d)
                          for i, d in enumerate(self.slots)])

    def _run(self, shards) -> torch.Tensor:
        devices = [e.device for e in shards]
        ops = {d: _round_ops(d, self.lift_steps) for d in devices}
        zero = {d: WorkCounters.zeros(d) for d in devices}
        segments = [rounds.pad_and_segment(e, self.plan) for e in shards]
        pis = _replicate(torch.arange(self.num_nodes, dtype=torch.int32,
                                      device=devices[0]), devices)
        n_rounds, done = 0, False
        while not done and n_rounds < _MAX_ROUNDS:
            local = [rounds.segment_scan(p, s, ops[d], zero[d])[0]
                     for p, s, d in zip(pis, segments, devices)]
            merged = pmin(local)
            fixed = {}
            for p in merged:        # one compress per device
                if p.device not in fixed:
                    fixed[p.device] = _compress(p)
            pis = [fixed[p.device] for p in merged]
            ok = None
            for p, e in zip(pis, shards):
                local_ok = (p[e[:, 0]] == p[e[:, 1]]).all()
                ok = local_ok if ok is None \
                    else ok & local_ok.to(ok.device)
            done = bool(ok)         # the round's one read back
            n_rounds += 1
        self.last_rounds = n_rounds
        return pis[0]


def build_distributed_cc(graph, mesh, axis_names=("data",),
                         lift_steps: int = 2,
                         local_segments: int | None = None) -> DistributedCC:
    """Build the multi-shard engine for a sharded ``DeviceGraph``
    (engine entry of the facade's ``distributed`` backend; callers
    should go through ``repro_torch.api.Solver.open(graph, mesh=mesh)``).

    Args:
      graph: a ``DeviceGraph`` whose (padded) row count divides into the
        mesh's slots (``DeviceGraph.shard(mesh, axis_names)``). Only its
        row count and |V| are read, so a graph on the ``meta`` device
        builds an engine without allocating. The engine runs on any
        graph of that shape.
      mesh: a ``repro_torch.launch.mesh.Mesh``; the edges are split over
        ``axis_names`` (flattened).
      local_segments: per-slot segmentation (None: the paper's heuristic
        on the per-slot subproblem).

    Returns:
      a ``DistributedCC``: ``fn(graph) -> labels [V]`` on slot 0's
      device, with ``fn.on_edges(edges)`` and ``fn.last_rounds``.
    """
    return DistributedCC(graph.num_nodes, int(graph.edges.shape[0]), mesh,
                         axis_names, lift_steps, local_segments)


class DistributedRunnerCache:
    """Per-shape cache of ``build_distributed_cc`` engines.

    An engine is specialised to one (padded rows, |V|) shape and runs on
    any same-shape sharded graph. The fleet's sharded tenants lean on
    this: a tenant's tombstone log re-solves after every mutated tick
    over a view whose power-of-two capacity changes only on growth, so
    one engine serves a capacity bucket. Host-side dict only; hits and
    misses ride in ``stats``."""

    def __init__(self, mesh, axis_names=("data",), lift_steps: int = 2):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.lift_steps = lift_steps
        self._runners: dict = {}
        self.stats = {"hits": 0, "misses": 0}

    def runner(self, graph) -> DistributedCC:
        """The cached engine for this graph's (rows, |V|) bucket; the
        graph must already be sharded over the cache's mesh."""
        key = (int(graph.edges.shape[0]), graph.num_nodes)
        fn = self._runners.get(key)
        if fn is None:
            self.stats["misses"] += 1
            fn = self._runners[key] = build_distributed_cc(
                graph, self.mesh, axis_names=self.axis_names,
                lift_steps=self.lift_steps)
        else:
            self.stats["hits"] += 1
        return fn

    def run(self, graph) -> torch.Tensor:
        """Labels [V] for a sharded DeviceGraph."""
        return self.runner(graph)(graph)

    def solve(self, graph) -> torch.Tensor:
        """Shard an unsharded DeviceGraph over the mesh, then run."""
        return self.run(graph.shard(self.mesh, self.axis_names))


def solve_distributed(graph, mesh, axis_names=("data",),
                      lift_steps: int = 2) -> torch.Tensor:
    """Shard a graph (host ``Graph``, raw arrays, or an unsharded
    ``DeviceGraph``) over ``mesh`` and run (engine entry of the facade's
    ``distributed`` backend). Host data goes to slot 0's device."""
    if not isinstance(graph, DeviceGraph):
        graph = as_device_graph(graph,
                                device=mesh.slot_devices(axis_names)[0])
    dg = graph.shard(mesh, axis_names)
    fn = build_distributed_cc(dg, mesh, axis_names=axis_names,
                              lift_steps=lift_steps)
    return fn(dg)
