"""Backend protocol and the pluggable ``BACKENDS`` registry of
``repro.api.registry``, for the port.

Every execution mode registers here under one contract:

  * a ``Capabilities`` descriptor saying which workloads the backend
    takes (static / batched / streaming / deletions / sharded) and
    whether its ``WorkCounters`` are exact true-work counters;
  * a ``run(plan) -> CCResult`` entry point consuming an
    ``ExecutionPlan`` (``repro_torch.api.plan``);
  * optionally a ``make_state(num_nodes, ...)`` factory for streaming
    backends: the ``Solver`` session asks the registry for its live
    state instead of naming an engine class.

Adding a backend is one decorator::

    @register_backend("my-engine", Capabilities(static=True))
    def _run(plan):
        return my_engine(plan.graph, lift_steps=plan.lift_steps)

The trace specs that feed ``repro.analysis`` (``VarInfo``,
``TraceEntry``) are not ported yet (ROADMAP.md queue A, item A12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can run, as data."""

    static: bool = True            # one-shot solve over a fixed edge set
    batched: bool = False          # many graphs, one device program
    streaming: bool = False        # absorbs edge insertions into live state
    deletions: bool = False        # absorbs edge deletions (tombstone log)
    sharded: bool = False          # runs over a multi-device mesh
    device_loop: bool = True       # control flow on device (no host syncs)
    # exact true-work WorkCounters (padding never billed; pallas_fused's
    # also equal the torch-ops adaptive composition's)
    bit_exact_counters: bool = False
    # records the spanning forest during hook rounds (the parent-edge
    # table behind Solver.spanning_forest(); property-tested)
    spanning_forest: bool = False
    # keeps the spanning forest as a maintained device resident across
    # mutations rather than recomputing it on demand
    maintained_forest: bool = False

    def describe(self) -> str:
        flag = lambda b: "y" if b else "n"          # noqa: E731
        return (f"static={flag(self.static)} batched={flag(self.batched)} "
                f"streaming={flag(self.streaming)} "
                f"deletions={flag(self.deletions)} "
                f"sharded={flag(self.sharded)} "
                f"device_loop={flag(self.device_loop)} "
                f"bit_exact_counters={flag(self.bit_exact_counters)} "
                f"spanning_forest={flag(self.spanning_forest)} "
                f"maintained_forest={flag(self.maintained_forest)}")


@runtime_checkable
class Backend(Protocol):
    """The uniform backend contract the Solver dispatches against."""

    name: str
    capabilities: Capabilities

    def run(self, plan: Any) -> Any:                 # -> CCResult
        ...


class _FunctionBackend:
    """Adapter: a plain ``run(plan)`` function as a Backend."""

    def __init__(self, name: str, capabilities: Capabilities,
                 fn: Callable[[Any], Any]):
        self.name = name
        self.capabilities = capabilities
        self._fn = fn

    def run(self, plan):
        return self._fn(plan)

    def __repr__(self) -> str:
        return f"<Backend {self.name!r} {self.capabilities.describe()}>"


BACKENDS: Dict[str, Backend] = {}


def register_backend(name: str, capabilities: Capabilities):
    """Class or function decorator registering an execution backend: a
    class exposing ``run(self, plan)`` (instantiated once, with
    ``name`` and ``capabilities`` attached; a ``make_state`` method
    marks a streaming backend) or a bare ``run(plan)`` function."""
    def deco(obj):
        if name in BACKENDS:
            raise ValueError(f"backend {name!r} already registered")
        if isinstance(obj, type):
            backend = obj()
            backend.name = name
            backend.capabilities = capabilities
        else:
            backend = _FunctionBackend(name, capabilities, obj)
        BACKENDS[name] = backend
        return obj
    return deco


def get_backend(name: str) -> Backend:
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; registered backends: "
                       f"{sorted(BACKENDS)}")
    return BACKENDS[name]


def available_backends() -> list[str]:
    return sorted(BACKENDS)


def capability_matrix() -> dict[str, dict]:
    """``{backend: {capability: bool}}``: the registry's contents as
    data."""
    return {name: dataclasses.asdict(b.capabilities)
            for name, b in sorted(BACKENDS.items())}
