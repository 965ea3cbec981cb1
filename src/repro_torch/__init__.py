"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice:

  * adaptive work-efficient connected components (the static solve
    path, the spanning forest, the sampled engines, the queries, the
    incremental and fully-dynamic engines behind ``Solver.insert`` /
    ``delete``, the batched engine behind ``Solver.solve_batch``, the
    ``Solver`` front door with its method policy, the multi-tenant
    registry and microbatching service with latency SLOs, the
    multi-shard engine behind ``Solver.open(g, mesh=...)`` and the
    ``cc-adaptive`` cell, and the fleet over a mesh of devices), with
    hand-written Hopper kernels behind the ``pallas``, ``pallas_fused``,
    ``sampled_fused``, ``batched`` and ``distributed`` backends and the
    fused scoped delete (``core``, ``graphs``, ``connectivity``,
    ``api``, ``obs``, ``launch``, ``fleet``);
  * the recsys serving path: DCN-v2 ``serve`` and ``retrieval`` cells
    (``launch.steps.build_cell``, ``models.recsys``, ``configs``,
    ``data.pipeline``), with the embedding-bag and segment-reduce
    kernels behind its lookups;
  * the LM serving path: the GQA transformer (gemma2-2b, qwen2.5-32b)
    behind the continuous-batching ``serving.engine.Engine`` and
    ``generate`` (``models.transformer``, ``configs``), with the
    flash-attention kernel behind every prefill attention.

Its front door is ``Solver`` / ``solve`` (``repro_torch.api``), as in
the reference::

    from repro_torch import Solver, solve

    res = solve(edges, num_nodes)            # one-shot, method="auto"
    s = Solver.open(edges, num_nodes)        # a session
    print(s.plan().explain())                # the adaptive decision

It imports ``torch`` and ``numpy`` (``scipy`` lazily) and nothing of
``jax`` or ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``. The recsys and LM modules load on import of their own
submodules, not of this package.
"""
from repro_torch.api import (BACKENDS, Backend, Capabilities,
                             ExecutionPlan, Solver, available_backends,
                             capability_matrix, get_backend,
                             register_backend, solve)
# the package's public engine entries, the names the reference exports
# analysis: ok[kernel-ast]
from repro_torch.core.cc import (CCResult, solve_hostloop, solve_pallas,
                                 solve_static)
from repro_torch.core.rounds import WorkCounters
from repro_torch.graphs.device import DeviceGraph

__all__ = ["BACKENDS", "Backend", "CCResult", "Capabilities", "DeviceGraph",
           "ExecutionPlan", "Solver", "WorkCounters", "available_backends",
           "capability_matrix", "get_backend", "register_backend", "solve",
           "solve_hostloop", "solve_pallas", "solve_static"]
