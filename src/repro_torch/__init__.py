"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice:

  * adaptive work-efficient connected components (the static solve
    path), with hand-written Hopper kernels behind the ``pallas`` and
    ``pallas_fused`` backends (``core``, ``graphs``);
  * the recsys serving path: DCN-v2 ``serve`` and ``retrieval`` cells
    (``launch.steps.build_cell``, ``models.recsys``, ``configs``,
    ``data.pipeline``), with the embedding-bag and segment-reduce
    kernels behind its lookups.

It imports ``torch`` and ``numpy`` (``scipy`` lazily) and nothing of
``jax`` or ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``. The recsys modules load on import of their own
submodules, not of this package.
"""
from repro_torch.core.cc import (CCResult, solve_hostloop, solve_pallas,
                                 solve_static)
from repro_torch.core.rounds import WorkCounters
from repro_torch.graphs.device import DeviceGraph

__all__ = ["CCResult", "DeviceGraph", "WorkCounters", "solve_hostloop",
           "solve_pallas", "solve_static"]
