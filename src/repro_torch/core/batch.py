"""Shape buckets of ``repro.core.batch``: the power-of-two rule that the
solver's plans and the autotune cache key on, and the row padding that
routes query batches of one size class through one shape. The batched
engine itself is not ported yet (ROADMAP.md queue A, item A8)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.device import next_pow2

_MIN_NODES = 8
_MIN_EDGES = 8


def pad_rows_pow2(arr: np.ndarray, min_rows: int = _MIN_EDGES
                  ) -> np.ndarray:
    """Pad axis 0 with zero rows to a power-of-two count (floored at
    ``min_rows``). Zero rows are no-ops for every query (vertex 0
    against itself)."""
    arr = np.asarray(arr)
    target = next_pow2(max(arr.shape[0], min_rows))
    if target == arr.shape[0]:
        return arr
    pad = np.zeros((target - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def bucket_shape(num_nodes: int, num_edges: int) -> tuple[int, int]:
    """The (V_pad, E_pad) bucket a graph lands in: the next powers of
    two, floored at small minima."""
    return (next_pow2(max(num_nodes, _MIN_NODES)),
            next_pow2(max(num_edges, _MIN_EDGES)))
