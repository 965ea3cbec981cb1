"""Placement planner: which device serves which tenant (DESIGN.md §15),
the port of ``repro.fleet.placement``.

Two tenant classes fall out of the work model:

  * **packed tenants** — small enough that one device serves many; the
    planner bin-packs them onto the mesh's devices by PREDICTED work,
    reusing the same per-round cost model ``ExecutionPlan.predicted``
    attaches (hook ops scale with |E| per round, jump ops with |V| per
    compress sweep) — placement and the execution planner can't drift
    apart because they read one model;
  * **sharded tenants** — predicted work at or above
    ``shard_threshold``; no single device should own one, so they
    route onto sharded ``DeviceGraph``s served by the multi-shard
    engine of the ``distributed`` backend across the WHOLE mesh
    (``core.distributed``), not onto any one bin.

Packing is greedy LPT (longest-processing-time first): tenants sorted
by descending work, each assigned to the currently lightest device —
the classic 4/3-approximation, deterministic (ties break on device
index) so a replan over unchanged specs is a fixed point and the
rebalancer never oscillates.

``imbalance(loads)`` (max/mean) is the rebalance trigger the fleet
service polls: merge/split-driven growth drifts per-device load, and
when the ratio crosses the service's factor it replans against LIVE
edge counts and migrates the moved tenants.

Everything here is host-side metadata — planning touches no device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.plan import ExecutionPlan
from repro_torch.connectivity import policy
from repro_torch.core.batch import bucket_shape
from repro_torch.core.segmentation import plan_segmentation

# Predicted-work floor for routing a tenant onto the sharded/
# distributed path instead of packing it onto one device. In work
# units (hook ops per round + jump ops per sweep = |E| + |V|); the
# CI-scale benchmark overrides it to exercise both classes.
DEFAULT_SHARD_THRESHOLD = 1 << 22


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Host-side sizing facts the planner packs on: |V| is exact,
    ``num_edges`` is the expected (admission) or live (rebalance)
    count — the same host-known upper bound the policy's size feature
    uses; reading the exact alive count would sync."""

    name: str
    num_nodes: int
    num_edges: int = 0
    degree_skew: float | None = None


def size_plan(num_nodes: int, num_edges: int, *,
              degree_skew: float | None = None,
              cache: policy.AutotuneCache | None = None) -> ExecutionPlan:
    """An ``ExecutionPlan`` for a bare (|V|, |E|) size — the same
    backend choice and ``predicted`` work model ``Solver._build_plan``
    attaches, without opening a session or touching a device. This is
    the planner's one costing primitive."""
    num_nodes, num_edges = int(num_nodes), int(num_edges)
    chosen, reason = policy.select_static_explained(
        num_nodes, num_edges, degree_skew=degree_skew, cache=cache)
    seg = plan_segmentation(num_edges, num_nodes)
    predicted = {"hook_ops_per_round": num_edges,
                 "jump_ops_per_sweep": num_nodes,
                 "segments": seg.num_segments}
    if degree_skew is not None:
        predicted["degree_skew"] = round(float(degree_skew), 3)
    return ExecutionPlan(backend=chosen, reason=reason,
                         num_nodes=num_nodes, num_edges=num_edges,
                         bucket=bucket_shape(num_nodes, num_edges),
                         segmentation=seg, predicted=predicted)


def predicted_work(num_nodes: int, num_edges: int, *,
                   degree_skew: float | None = None,
                   cache: policy.AutotuneCache | None = None) -> int:
    """Scalar packing weight from ``ExecutionPlan.predicted``: hook
    ops per round + jump ops per sweep (= |E| + |V|) — proportional to
    one adaptive round over the tenant, which is what a steady-state
    tick costs."""
    p = size_plan(num_nodes, num_edges, degree_skew=degree_skew,
                  cache=cache).predicted
    return int(p["hook_ops_per_round"]) + int(p["jump_ops_per_sweep"])


def imbalance(loads) -> float:
    """max/mean over per-device loads — the rebalance trigger. 1.0
    (perfectly balanced) when nothing is loaded."""
    loads = list(loads)
    total = sum(loads)
    if not loads or total <= 0:
        return 1.0
    return max(loads) / (total / len(loads))


@dataclasses.dataclass
class PlacementPlan:
    """One planning decision: packed assignments + sharded routing."""

    device_of: dict                  # packed tenant -> device index
    sharded: tuple                   # tenants routed to the mesh
    loads: tuple                     # predicted work per device
    work: dict                       # tenant -> predicted work units
    shard_threshold: int

    def imbalance(self) -> float:
        return imbalance(self.loads)

    def explain(self) -> str:
        lines = [f"placement over {len(self.loads)} device(s), "
                 f"shard_threshold={self.shard_threshold}:"]
        for name in sorted(self.sharded):
            lines.append(f"  {name}: SHARDED across the mesh "
                         f"(work={self.work[name]})")
        by_dev: dict[int, list] = {}
        for name, idx in self.device_of.items():
            by_dev.setdefault(idx, []).append(name)
        for idx in range(len(self.loads)):
            names = ", ".join(sorted(by_dev.get(idx, []))) or "-"
            lines.append(f"  device[{idx}] load={self.loads[idx]}: "
                         f"{names}")
        lines.append(f"  imbalance(max/mean)={self.imbalance():.3f}")
        return "\n".join(lines)


def plan_placement(specs, n_devices: int, *,
                   shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
                   cache: policy.AutotuneCache | None = None
                   ) -> PlacementPlan:
    """Route + pack a tenant fleet over ``n_devices`` devices.

    Tenants whose predicted work reaches ``shard_threshold`` go to the
    sharded class; the rest LPT-pack onto devices. Deterministic for a
    given spec list (sort by (-work, name); lightest device wins, ties
    on index)."""
    if n_devices < 1:
        raise ValueError("plan_placement needs at least one device")
    specs = list(specs)
    if len({s.name for s in specs}) != len(specs):
        raise ValueError("duplicate tenant names in placement specs")
    work = {s.name: predicted_work(s.num_nodes, s.num_edges,
                                   degree_skew=s.degree_skew,
                                   cache=cache)
            for s in specs}
    sharded = tuple(sorted(s.name for s in specs
                           if work[s.name] >= shard_threshold))
    packed = sorted((s for s in specs if s.name not in sharded),
                    key=lambda s: (-work[s.name], s.name))
    loads = [0] * n_devices
    device_of: dict[str, int] = {}
    for s in packed:
        idx = min(range(n_devices), key=lambda i: (loads[i], i))
        device_of[s.name] = idx
        loads[idx] += work[s.name]
    return PlacementPlan(device_of=device_of, sharded=sharded,
                         loads=tuple(loads), work=work,
                         shard_threshold=shard_threshold)
