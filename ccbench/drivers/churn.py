"""A ``Solver`` session over a graph that keeps changing, one client in a
closed loop: the reference benchmark's dynamic table at a delete:insert
ratio of 1, made steady.

Set-up makes the configuration's graph from the seed on the device and
keeps its distinct undirected edges (no self loops, no duplicates: a
dynamic graph is a set, and a delete retires every copy of an edge),
permutes them by the seed, opens a session on the first
``open_num / open_den`` of them and solves (the session's first, bulk,
insert), and runs ``warmup_ticks`` ticks through the window's own call.
The rest is the pool.

A tick inserts ``batch`` edges taken from the pool, then deletes
``batch`` edges drawn uniformly from the live set; the deleted edges go
back to the pool, so the live set keeps its size. Each batch reaches
the session as a ``DeviceGraph`` over a CUDA tensor. The tick is timed
from the insert call until ``Solver.labels`` is current (a
synchronise); the draw of the next batches stays out of it. Traced, the
insert and the delete run under spans of their own, the session's
``WorkCounters`` are read before and after the window, and each delete
span is summed under the route the policy gave it.

The answers kept for the check: the labels after the last tick and
after a sample of ``sample`` more ticks drawn from the seed, each with
the live edge set the harness tracked. The control (``--control
truncated``) puts the plain reference, cut one hooking round short, over
the tracked live set in the program's place.
"""
from __future__ import annotations

import time

import torch

from ccbench import harness, reference


def distinct_undirected(edges: torch.Tensor) -> torch.Tensor:
    """The distinct undirected edges of ``edges`` as (min, max) rows,
    self loops dropped, in ascending order."""
    lo = torch.minimum(edges[:, 0], edges[:, 1]).long()
    hi = torch.maximum(edges[:, 0], edges[:, 1]).long()
    keys = torch.unique(((lo << 32) | hi)[lo != hi])
    return torch.stack([keys >> 32, keys & 0xFFFFFFFF], 1).to(torch.int32)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.batch = int(self.t["batch"])
        self.num_nodes = 0
        self.num_edges = 0
        self.session = None
        self.labels = None
        self.ticks = 0
        self.work0 = None
        self.work_edges = 0
        self.hook_ops = 0
        self.delete_s: dict = {}
        self.sample = None
        self.final = None
        self.marks: dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.api import Solver
        dev = self.cell.device
        edges, n = self.cell.graph("graph")
        generated = int(edges.shape[0])
        self.cell.mark(self.marks, "generated")
        edges = distinct_undirected(edges)
        edges = edges[torch.randperm(edges.shape[0], device=dev,
                                     generator=harness.generator(
                                         dev, self.cell.seed, "order"))]
        e = int(edges.shape[0])
        live = e * int(self.t["open_num"]) // int(self.t["open_den"])
        self.num_nodes, self.num_edges = n, live
        self.live = edges[:live].clone()
        self.pool = edges[live:].clone()
        del edges
        if self.pool.shape[0] < self.batch or live < self.batch:
            raise ValueError(f"{e} distinct edges do not hold a pool and a "
                             f"live set of {self.batch} each")
        self.head = 0
        self.stream = harness.generator(dev, self.cell.seed, "stream")
        self.cell.say(f"|V| {n}, generated {generated} edges, {e} distinct; "
                      f"live {live}, pool {int(self.pool.shape[0])}, "
                      f"batch {self.batch}")
        if self.cell.control is None:
            self.session = Solver.open(self.live.clone(), n)
            self.labels = self.session.labels        # the bulk first insert
        elif self.cell.control != "truncated":
            raise ValueError(f"unknown control {self.cell.control!r}")
        harness.sync(dev)
        self.cell.mark(self.marks, "opened")
        self._say_state("opened")
        for _ in range(int(self.t["warmup_ticks"])):
            self.step(None)
        harness.sync(dev)
        self.cell.mark(self.marks, "warmed")
        self._say_state("warmed")
        self.stats0 = dict(self.session.stats) if self.session else {}
        self.ticks = 0
        self.sample = harness.Reservoir(
            int(self.t["sample"]), harness.seed_for(self.cell.seed, "sample"))

    def _say_state(self, when: str) -> None:
        s = self.session
        if s is None:
            return
        dyn = s.state
        self.cell.say(f"{when}: last route {s.last_method}, stats {s.stats}, "
                      f"log rows {dyn.log.rows} capacity {dyn.log.capacity}, "
                      f"policy |E| {s.num_edges}")

    # -- the harness's bookkeeping ------------------------------------------

    def _draw(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The next tick's insert batch (the pool's next rows) and delete
        batch (distinct live positions drawn uniformly), with the live set
        and the pool updated to what they hold after the tick."""
        dev, d = self.cell.device, self.batch
        p, n_live = int(self.pool.shape[0]), int(self.live.shape[0])
        ring = (self.head + torch.arange(d, device=dev)) % p
        ins = self.pool[ring].clone()
        pos = torch.unique(torch.randint(n_live, (d + d // 4 + 64,),
                                         device=dev, generator=self.stream))
        while pos.shape[0] < d:
            more = torch.randint(n_live, (d,), device=dev,
                                 generator=self.stream)
            pos = torch.unique(torch.cat([pos, more]))
        pos = pos[torch.randperm(pos.shape[0], device=dev,
                                 generator=self.stream)[:d]]
        dels = self.live[pos].clone()
        self.live[pos] = ins
        self.pool[ring] = dels
        self.head = (self.head + d) % p
        return ins, dels

    # -- the timed call -----------------------------------------------------

    def step(self, spans) -> tuple[float, int]:
        from repro_torch.api import DeviceGraph
        ins, dels = self._draw()
        harness.sync(self.cell.device)
        n = self.num_nodes
        traced = spans is not None and self.cell.control is None
        if traced and spans.record and self.work0 is None:
            self.work0 = self.session.work["hook_ops"]
        t0 = time.perf_counter()
        if self.cell.control is not None:
            self.labels = reference.cc_labels(self.live, n,
                                              stop_short=True)[0]
            harness.sync(self.cell.device)
        elif not traced:
            self.session.insert(DeviceGraph.from_edges(ins, n))
            self.session.delete(DeviceGraph.from_edges(dels, n))
            self.labels = self.session.labels
            harness.sync(self.cell.device)
        else:
            with spans("insert"):
                self.session.insert(DeviceGraph.from_edges(ins, n))
            with spans("delete"):
                self.session.delete(DeviceGraph.from_edges(dels, n))
            self.labels = self.session.labels
        dt = time.perf_counter() - t0
        if traced and spans.record:
            # read back after the tick's timer stopped: the session's
            # counters, and so the work of this tick alone, and the
            # route the policy gave this tick's delete
            now = self.session.work["hook_ops"]
            self.hook_ops += now - self.work0
            self.work0 = now
            self.work_edges += 2 * self.batch
            route = self.session.last_method
            self.delete_s[route] = self.delete_s.get(route, 0.0) \
                + spans.times["delete"][-1]
        self.ticks += 1
        if self.sample is not None:
            self.sample.offer(self._snapshot)
        return dt, 2 * self.batch

    def _snapshot(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.labels.clone(), self.live.clone()

    # -- after the window ---------------------------------------------------

    def counters(self) -> dict:
        return {"hook_ops": self.hook_ops, "updated_edges": self.work_edges,
                "ticks": self.ticks, "delete_s_by_route": dict(self.delete_s)}

    def describe(self) -> list:
        s = self.session
        if s is None:
            return [f"ticks {self.ticks}"]
        delta = {k: v - self.stats0.get(k, 0) for k, v in s.stats.items()}
        dyn = s.state
        routes = dyn.delete_route_counts(flush_obs=False)
        return [f"ticks {self.ticks}; session stats over the window and "
                f"the traced ticks {delta}; last route {s.last_method}; "
                f"forest delete routes {routes}",
                f"log rows {dyn.log.rows} capacity {dyn.log.capacity}, "
                f"policy |E| {s.num_edges}, live {self.num_edges}"]

    def release(self) -> None:
        """Keep the last tick's answer, then free the session."""
        self.final = self._snapshot()
        self.session = None
        self.labels = None

    def check(self) -> dict:
        kept = [self.final] + list(self.sample.items)
        bad = 0
        for labels, live in kept:
            want, _ = reference.cc_labels(live, self.num_nodes)
            bad += reference.mismatches(labels, want)
            del want
        return {"label_mismatches": (bad, 0),
                "answers_missing": (0 if kept else 1, 0)}
