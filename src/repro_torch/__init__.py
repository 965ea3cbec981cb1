"""repro_torch — the PyTorch/CUDA port of ``repro``: adaptive
work-efficient connected components (the static solve path), with
hand-written Hopper kernels behind the ``pallas`` and ``pallas_fused``
backends.

It imports ``torch`` and ``numpy`` (``scipy`` lazily) and nothing of
``jax`` or ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from repro_torch.core.cc import (CCResult, solve_hostloop, solve_pallas,
                                 solve_static)
from repro_torch.core.rounds import WorkCounters
from repro_torch.graphs.device import DeviceGraph

__all__ = ["CCResult", "DeviceGraph", "WorkCounters", "solve_hostloop",
           "solve_pallas", "solve_static"]
