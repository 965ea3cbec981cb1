"""Deterministic synthetic data with bounded prefetch: the recsys part
of ``repro.data.pipeline``, copied (numpy only).

Every batch is a dict of numpy arrays. Determinism: batch ``i`` of
stream ``seed`` is a pure function of ``(seed, i)``, bit-identical to
the reference's.

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
