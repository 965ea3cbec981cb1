"""Back-to-back one-shot solves through the front door, one client in a
closed loop.

Set-up makes ``instances`` graphs of the configuration from the seed,
on the device, and solves each once through the window's own call. The
window rotates through them, so that no two consecutive solves share an
answer. Untraced, an iteration is ``repro_torch.api.solve(edges,
num_nodes)`` with ``method="auto"`` on a CUDA int32 [E, 2] tensor, timed
from the call until its labels are ready (a synchronise). Traced, the
three steps that ``solve`` composes, ``Solver.open``, ``.plan("auto")``
and ``plan.run()``, run under spans of their own, and each solve's
``WorkCounters.hook_ops`` is read.

The answers kept for the check: each instance's last labels and a
sample of ``sample`` more solves drawn from the seed. The control
(``--control truncated``) puts the plain reference, cut one hooking
round short, in the program's place.
"""
from __future__ import annotations

import time

import torch

from ccbench import harness, reference


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.instances: list = []
        self.num_nodes = 0
        self.num_edges = 0
        self.done = 0
        self.hook_ops = 0
        self.hook_edges = 0
        self.plans: dict = {}
        self.last: dict = {}
        self.sample = None
        self.marks: dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.api import Solver
        for i in range(int(self.t["instances"])):
            edges, n = self.cell.graph("instance", i)
            self.instances.append(edges)
            self.num_nodes = n
        harness.sync(self.cell.device)
        self.cell.mark(self.marks, "generated")
        self.num_edges = sum(int(e.shape[0]) for e in self.instances) \
            / len(self.instances)
        self.cell.say(f"{len(self.instances)} instances, |V| "
                      f"{self.num_nodes}, |E| "
                      f"{[int(e.shape[0]) for e in self.instances]}")
        plan = Solver.open(self.instances[0], self.num_nodes).plan("auto")
        seg = plan.segmentation
        self.cell.say(f"plan backend {plan.backend}, reason {plan.reason}, "
                      f"segments {seg.num_segments} x {seg.segment_size}")
        # warm-up: every instance once through the path this run takes
        warm = None
        if self.cell.traced:
            warm = harness.Spans(self.cell.device)
            warm.record = False
        for _ in range(len(self.instances)):
            self.step(warm)
        self.cell.mark(self.marks, "warmed")
        self.done, self.hook_ops, self.hook_edges = 0, 0, 0
        self.last.clear()
        self.sample = harness.Reservoir(
            int(self.t["sample"]), harness.seed_for(self.cell.seed, "sample"))

    # -- the timed call -----------------------------------------------------

    def _solve(self, edges: torch.Tensor):
        if self.cell.control == "truncated":
            return reference.cc_labels(edges, self.num_nodes,
                                       stop_short=True)[0]
        if self.cell.control is not None:
            raise ValueError(f"unknown control {self.cell.control!r}")
        from repro_torch.api import solve
        return solve(edges, self.num_nodes).labels

    def step(self, spans) -> tuple[float, int]:
        from repro_torch.api import Solver
        i = self.done % len(self.instances)
        edges = self.instances[i]
        dev = self.cell.device
        t0 = time.perf_counter()
        if spans is None or self.cell.control is not None:
            labels = self._solve(edges)
            harness.sync(dev)
        else:
            with spans("open"):
                s = Solver.open(edges, self.num_nodes)
            with spans("plan"):
                plan = s.plan("auto")
            with spans("run"):
                res = plan.run()
            labels = res.labels
        dt = time.perf_counter() - t0
        if spans is not None and spans.record and self.cell.control is None:
            self.hook_ops += int(res.work.hook_ops)
            self.hook_edges += int(edges.shape[0])
            self.plans[plan.backend] = self.plans.get(plan.backend, 0) + 1
        self.done += 1
        self.last[i] = labels
        if self.sample is not None:
            self.sample.offer(lambda: (i, labels))
        return dt, int(edges.shape[0])

    # -- after the window ---------------------------------------------------

    def counters(self) -> dict:
        return {"hook_ops": self.hook_ops, "hook_edges": self.hook_edges,
                "solves": self.done}

    def describe(self) -> list:
        lines = [f"solves {self.done}"]
        if self.plans:
            lines.append(f"traced plans by backend {self.plans}")
        return lines

    def release(self) -> None:
        """Nothing of the program outlives a solve but its labels."""

    def check(self) -> dict:
        kept = list(self.last.items()) + list(self.sample.items
                                              if self.sample else [])
        bad = 0
        for i in sorted({i for i, _ in kept}):
            want, _ = reference.cc_labels(self.instances[i], self.num_nodes)
            bad += sum(reference.mismatches(lab, want)
                       for j, lab in kept if j == i)
            del want
        return {"label_mismatches": (bad, 0),
                "answers_missing": (0 if kept else 1, 0)}
