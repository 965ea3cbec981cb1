"""Deterministic synthetic data with bounded prefetch: the generators of
``repro.data.pipeline`` (LM tokens, recsys, graph nodes, molecules),
copied (numpy only).

Every batch is a dict of numpy arrays. Determinism: batch ``i`` of
stream ``seed`` is a pure function of ``(seed, i)``, bit-identical to
the reference's, so a restart resumes the exact stream.

``Prefetcher`` runs the generator in a daemon thread ahead of the
device step through a bounded queue, so host-side batch construction
overlaps the device step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((seed, step)))


def lm_batch(seed: int, step: int, batch: int, seq: int,
             vocab: int) -> dict:
    """Zipf-ish token stream: [B, S+1] (inputs + shifted labels)."""
    rng = _rng_for(seed, step)
    z = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    return {"tokens": np.minimum(z, vocab - 1).astype(np.int32)}


def lm_batches(seed: int, batch: int, seq: int, vocab: int,
               start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(seed, step, batch, seq, vocab)
        step += 1


def recsys_batch(seed: int, step: int, batch: int, n_dense: int,
                 table_sizes: tuple) -> dict:
    rng = _rng_for(seed, step)
    idx = np.stack(
        [rng.integers(0, s, batch) for s in table_sizes], axis=1)
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    # click probability correlated with features so training can learn
    score = dense[:, 0] + 0.1 * (idx[:, 0] % 7 - 3)
    label = (score + rng.standard_normal(batch) > 0).astype(np.int32)
    return {"dense": dense, "sparse_idx": idx.astype(np.int32),
            "label": label}


def recsys_batches(seed: int, batch: int, n_dense: int, table_sizes: tuple,
                   start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield recsys_batch(seed, step, batch, n_dense, table_sizes)
        step += 1


def graph_node_batch(seed: int, step: int, num_nodes: int, num_edges: int,
                     d_feat: int, n_classes: int) -> dict:
    """Full-graph node classification batch (fixed graph per seed; the
    per-step RNG only reshuffles the train mask, as real epochs do)."""
    g_rng = _rng_for(seed, 0)
    edges = g_rng.integers(0, num_nodes, size=(num_edges, 2))
    x = g_rng.standard_normal((num_nodes, d_feat)).astype(np.float32)
    y = g_rng.integers(0, n_classes, num_nodes).astype(np.int32)
    rng = _rng_for(seed, step)
    mask = (rng.random(num_nodes) < 0.5).astype(np.float32)
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return {"x": x, "src": sym[:, 0].astype(np.int32),
            "dst": sym[:, 1].astype(np.int32), "y": y,
            "node_mask": mask}


def molecule_energy_batch(seed: int, step: int, num_graphs: int,
                          nodes_per: int, edges_per: int,
                          n_species: int = 8) -> dict:
    """Block-diagonal molecule batch (positions + energies): a chain
    and random extra edges per graph, the target a pairwise LJ-ish
    energy."""
    rng = _rng_for(seed, step)
    v = num_graphs * nodes_per
    pos = rng.standard_normal((v, 3)).astype(np.float32) * 1.5
    species = rng.integers(0, n_species, v).astype(np.int32)
    blocks = []
    for g in range(num_graphs):
        base = g * nodes_per
        idx = np.arange(nodes_per - 1)
        chain = np.stack([idx, idx + 1], 1)
        extra = rng.integers(0, nodes_per,
                             size=(max(edges_per - len(chain), 0), 2))
        blocks.append(np.concatenate([chain, extra], 0) + base)
    e = np.concatenate(blocks, 0)
    sym = np.concatenate([e, e[:, ::-1]], axis=0)
    graph_ids = np.repeat(np.arange(num_graphs), nodes_per).astype(np.int32)
    d = np.linalg.norm(pos[sym[:, 0]] - pos[sym[:, 1]], axis=-1) + 0.5
    e_edge = 1.0 / d ** 2 - 1.0 / d
    energy = np.zeros(num_graphs, np.float32)
    np.add.at(energy, graph_ids[sym[:, 0]], e_edge.astype(np.float32))
    return {"positions": pos, "species": species,
            "src": sym[:, 0].astype(np.int32),
            "dst": sym[:, 1].astype(np.int32),
            "graph_ids": graph_ids, "energy": energy}


class Prefetcher:
    """Bounded-queue background prefetch around any batch iterator.

    ``depth`` bounds host memory and gives back-pressure; a sentinel
    propagates generator exhaustion; exceptions re-raise in the
    consumer.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:   # noqa: BLE001 — re-raised below
                self._err.append(e)
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


def make_stream(factory: Callable[..., Iterator[dict]], *args,
                prefetch: int = 2, **kw) -> Iterator[dict]:
    """Wrap a generator factory with prefetching."""
    return Prefetcher(factory(*args, **kw), depth=prefetch)
