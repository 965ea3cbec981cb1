"""Connectivity on top of the engines (``repro.connectivity``): the query
functions over canonical label arrays, the adaptive method-selection
policy, a multi-tenant registry with merge- and split-precise
invalidation, and a slot-based microbatching service."""
from repro_torch.connectivity.policy import (AutotuneCache, GraphFeatures,
                                             select_method)
from repro_torch.connectivity.queries import (component_histogram,
                                              component_size,
                                              component_sizes,
                                              count_components,
                                              same_component)
from repro_torch.connectivity.registry import GraphRegistry, TenantGraph
from repro_torch.connectivity.service import ConnectivityService, Request

__all__ = [
    "AutotuneCache", "GraphFeatures", "select_method",
    "component_histogram", "component_size", "component_sizes",
    "count_components", "same_component",
    "GraphRegistry", "TenantGraph",
    "ConnectivityService", "Request",
]
