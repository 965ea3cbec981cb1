"""Training loop assembly, the port of ``repro.train.loop``: model fns +
optimizer + pipeline -> training loop.

``fit`` is the single-process convenience loop; the launcher
(``repro_torch.launch.train``) runs the same ``make_train_step`` product
inside ``fault_tolerance.run_with_restarts``. The reference's ``jit``
switch has no counterpart: the step runs eagerly.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Iterator

from repro_torch.train import train_state
from repro_torch.train.optimizer import Optimizer


def fit(
    *,
    loss_fn: Callable,
    params,
    opt: Optimizer,
    stream: Iterator[dict],
    steps: int,
    log_every: int = 20,
    log_fn: Callable[[str], None] = print,
) -> tuple[dict, list[dict]]:
    """Train for ``steps`` steps on a copy of ``params`` (the step
    writes its state in place, and callers keep their parameters for
    before/after comparisons); returns (state, history). ``stream``
    yields batches of tensors on the parameters' device."""
    state = train_state.create(copy.deepcopy(params), opt)
    step_fn = train_state.make_train_step(loss_fn, opt)

    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(stream)
        state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["wall_s"] = round(time.perf_counter() - t0, 3)
            history.append(m)
            log_fn(f"step {i + 1:5d}  loss {m['loss']:.4f}  "
                   f"gnorm {m['grad_norm']:.3f}  {m['wall_s']:.1f}s")
    return state, history
