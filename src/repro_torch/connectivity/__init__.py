"""Connectivity on top of the engines: the query functions over
canonical label arrays and the adaptive method-selection policy. The
multi-tenant registry and the microbatching service of
``repro.connectivity`` are not ported yet (ROADMAP.md queue A, item
A9)."""
from repro_torch.connectivity.policy import (AutotuneCache, GraphFeatures,
                                             select_method)
from repro_torch.connectivity.queries import (component_histogram,
                                              component_size,
                                              component_sizes,
                                              count_components,
                                              same_component)

__all__ = [
    "AutotuneCache", "GraphFeatures", "select_method",
    "component_histogram", "component_size", "component_sizes",
    "count_components", "same_component",
]
