"""repro_torch.fleet — sharded multi-tenant serving across a mesh of
devices (DESIGN.md §15), the port of ``repro.fleet``.

Three layers, importable separately:

  * ``placement`` — work-model bin packing (packed tenants) and shard
    routing (mesh tenants), host-side only;
  * ``engine`` — the pipelined tick: batched cross-tenant query calls,
    double-buffered dispatch and collect over per-device shards;
  * ``service`` — the ``FleetService`` front door: admit / submit /
    step / retire, rebalancing, merged fleet SLOs.
"""
from repro_torch.fleet.engine import (BATCHED_KINDS, PendingGroup,
                                      PipelinedTickEngine, collect_group,
                                      dispatch_queries)
from repro_torch.fleet.placement import (DEFAULT_SHARD_THRESHOLD,
                                         PlacementPlan, TenantSpec,
                                         imbalance, plan_placement,
                                         predicted_work, size_plan)
from repro_torch.fleet.service import FleetService, ShardedTenant

__all__ = [
    "BATCHED_KINDS", "DEFAULT_SHARD_THRESHOLD", "FleetService",
    "PendingGroup", "PipelinedTickEngine", "PlacementPlan",
    "ShardedTenant", "TenantSpec", "collect_group", "dispatch_queries",
    "imbalance", "plan_placement", "predicted_work", "size_plan",
]
