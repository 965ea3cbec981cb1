"""Fault tolerance, the port of ``repro.train.fault_tolerance``:
restartable step loops and a straggler watchdog.

``run_with_restarts`` is the crash boundary: the step function may raise
(preemption, a flaky host, an injected test failure); the loop restores
the last checkpoint, rebuilds the data stream at the restored step (the
pipeline is (seed, step)-deterministic) and continues, up to
``max_restarts``.

``StepWatchdog`` keeps an EMA of the step time and flags outlier steps;
here it records the events for inspection and tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.train import checkpoint as ckpt_lib


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to exercise the restart path."""


@dataclasses.dataclass
class StepWatchdog:
    """Flags steps slower than ``threshold``x the EMA step time."""
    threshold: float = 3.0
    ema: Optional[float] = None
    alpha: float = 0.1
    slow_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.slow_steps.append((step, dt, self.ema))
        # don't fold outliers into the estimate
        if not slow:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


@dataclasses.dataclass
class RunReport:
    final_state: object
    restarts: int
    steps_run: int
    slow_steps: list


def run_with_restarts(
    *,
    init_state_fn: Callable[[], object],
    step_fn: Callable[[object, dict], tuple],
    stream_fn: Callable[[int], object],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    keep: int = 3,
    watchdog: Optional[StepWatchdog] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> RunReport:
    """Crash-tolerant training loop.

    * ``init_state_fn()`` builds a fresh TrainState; when a checkpoint
      exists, it is restored into that state.
    * ``stream_fn(start_step)`` (re)builds the data iterator from a step,
      so restarts resume the exact stream position.
    * ``step_fn(state, batch) -> (state, metrics)`` may raise
      (``SimulatedFailure`` or any ``RuntimeError``); the loop restores
      the newest checkpoint and replays.
    """
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep)
    watchdog = watchdog or StepWatchdog()
    restarts = 0
    steps_run = 0

    def load_or_init():
        last = ckpt_lib.latest_step(ckpt_dir)
        state = init_state_fn()
        if last is not None:
            state = ckpt_lib.restore(ckpt_dir, like=state, step=last)
            return state, last
        return state, 0

    state, start = load_or_init()
    while True:
        stream = stream_fn(start)
        try:
            step = start
            while step < total_steps:
                batch = next(stream)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                dt = time.perf_counter() - t0
                step += 1
                steps_run += 1
                watchdog.observe(step, dt)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % ckpt_every == 0 or step == total_steps:
                    saver.save(state, step)
            saver.wait()
            return RunReport(final_state=state, restarts=restarts,
                             steps_run=steps_run,
                             slow_steps=watchdog.slow_steps)
        except (SimulatedFailure, RuntimeError) as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={max_restarts}") from e
            saver.wait()
            state, start = load_or_init()
