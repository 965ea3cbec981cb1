"""repro_torch.api — the front door of the port (``repro.api``, its
static half).

The ``Solver`` facade routes a graph through the adaptive policy and the
pluggable ``BACKENDS`` registry, and reifies each decision as an
inspectable ``ExecutionPlan``::

    from repro_torch import Solver

    s = Solver.open(edges, num_nodes=n)      # a session (on CUDA)
    print(s.plan().explain())                # the adaptive decision
    res = s.solve()                          # CCResult(labels, work)
    s.connected(u, v); s.num_components()

Backends register with one decorator (``register_backend``).
"""
from repro_torch.api.registry import (BACKENDS, Backend, Capabilities,
                                      available_backends, capability_matrix,
                                      get_backend, register_backend)
from repro_torch.api.plan import ExecutionPlan
from repro_torch.api import backends as _backends     # registers built-ins
from repro_torch.api.solver import Solver, solve
from repro_torch.core.cc import CCResult
from repro_torch.core.rounds import WorkCounters
from repro_torch.graphs.device import DeviceGraph

__all__ = [
    "Solver",
    "solve",
    "ExecutionPlan",
    "Backend",
    "Capabilities",
    "BACKENDS",
    "register_backend",
    "get_backend",
    "available_backends",
    "capability_matrix",
    "CCResult",
    "WorkCounters",
    "DeviceGraph",
]
