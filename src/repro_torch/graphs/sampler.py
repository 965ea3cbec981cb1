"""GraphSAGE-style fanout neighbour sampler (host side, static shapes),
the port of ``repro.graphs.sampler``.

``minibatch_lg`` (Reddit-scale sampled training) needs a real neighbour
sampler: given CSR adjacency, seed nodes and per-layer fanouts, emit a
block of sampled edges per layer with static shapes (padded with
self-edges) so the training step keeps one shape. Host numpy: the same
``np.random.Generator`` calls in the same order as the reference's, so a
seed gives its minibatch exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graphs.format import CSR


@dataclasses.dataclass
class SampledBlock:
    """One message-passing layer block: edges from sampled neighbours
    (src) into destination nodes (dst). All node ids are global."""
    src: np.ndarray        # int32 [n_dst * fanout]
    dst: np.ndarray        # int32 [n_dst * fanout]
    dst_nodes: np.ndarray  # int32 [n_dst]: the nodes updated this layer


@dataclasses.dataclass
class MiniBatch:
    blocks: list[SampledBlock]      # ordered input-layer -> output-layer
    input_nodes: np.ndarray         # nodes whose features must be gathered
    seed_nodes: np.ndarray          # the batch's target nodes


def sample_neighbors(csr: CSR, nodes: np.ndarray, fanout: int,
                     rng: np.random.Generator) -> SampledBlock:
    """Uniform with-replacement fanout sampling; isolated nodes fall back
    to self-edges (a no-op message under mean aggregation with self)."""
    n = nodes.shape[0]
    src = np.empty((n, fanout), dtype=np.int32)
    for i, v in enumerate(nodes):
        lo, hi = csr.indptr[v], csr.indptr[v + 1]
        deg = hi - lo
        if deg == 0:
            src[i] = v
        else:
            sel = rng.integers(0, deg, size=fanout)
            src[i] = csr.indices[lo + sel]
    dst = np.repeat(nodes.astype(np.int32), fanout)
    return SampledBlock(src=src.reshape(-1), dst=dst,
                        dst_nodes=nodes.astype(np.int32))


def sample_minibatch(csr: CSR, seeds: np.ndarray,
                     fanouts: Sequence[int],
                     rng: np.random.Generator) -> MiniBatch:
    """Layered sampling (outermost layer first in ``fanouts``), DGL-style:
    the layer-k block updates the frontier of layer k+1."""
    blocks: list[SampledBlock] = []
    frontier = np.asarray(seeds, dtype=np.int32)
    # sample from the output layer inward
    for fanout in reversed(list(fanouts)):
        blk = sample_neighbors(csr, frontier, fanout, rng)
        blocks.append(blk)
        frontier = np.unique(np.concatenate([blk.src, frontier]))
    blocks.reverse()
    return MiniBatch(blocks=blocks, input_nodes=frontier,
                     seed_nodes=np.asarray(seeds, dtype=np.int32))


class MiniBatchLoader:
    """Deterministic, seeded, epoch-shuffling minibatch stream.
    ``prefetch`` is kept for the reference's signature: wrap ``epoch``
    in ``data.pipeline.Prefetcher`` to run the sampler ahead of the
    device step."""

    def __init__(self, csr: CSR, train_nodes: np.ndarray, batch_size: int,
                 fanouts: Sequence[int], seed: int = 0, prefetch: int = 2):
        self.csr = csr
        self.train_nodes = np.asarray(train_nodes, dtype=np.int32)
        self.batch_size = batch_size
        self.fanouts = list(fanouts)
        self.seed = seed
        self.prefetch = prefetch

    def epoch(self, epoch_idx: int):
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(self.train_nodes)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            seeds = order[i:i + self.batch_size]
            yield sample_minibatch(self.csr, seeds, self.fanouts, rng)
