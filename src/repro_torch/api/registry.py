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

The trace specs that feed ``repro_torch.analysis`` live here too
(``VarInfo``, ``TraceEntry``, ``register_trace_spec``,
``trace_entries``): every backend registers the programs it runs,
with ``meta`` tensors for example arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, \
    runtime_checkable


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


# ---------------------------------------------------------------------------
# Traceable entry specs (consumed by repro_torch.analysis)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VarInfo:
    """Static facts the analyzer knows about ONE flat argument.

    * ``range``  — inclusive (lo, hi) value bounds for integer inputs
      (vertex ids lie in [0, |V|-1], true counts in [0, |E|], ...);
      None = unbounded/unknown (the int32 pass treats it as TOP and
      never reports overflow through it); the tracer draws the inputs
      it runs on inside these bounds;
    * ``padded`` — the array carries rows past a true count (the
      prefix-padding / tombstone-log discipline): the padding-mask pass
      seeds its taint here;
    * ``mask``   — the argument IS a true-count scalar or alive mask:
      a sanitizer source for the padding-mask pass.
    """

    range: Optional[tuple] = None
    padded: bool = False
    mask: bool = False


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One traceable program of the stack, as data.

    ``build(num_nodes, num_edges)`` returns ``(fn, args, arg_info)``: a
    function over FLAT tensor arguments, example arguments (``meta``
    tensors, which play the part of the reference's
    ``ShapeDtypeStruct``s: nothing is allocated) or Python scalars, and
    a ``VarInfo`` per argument. ``repro_torch.analysis`` draws real
    inputs of those shapes and dtypes inside the ``VarInfo`` ranges,
    runs the entry once under a recording mode at each shape bucket and
    runs its checker passes over the record.

    ``contracts`` name the invariants the entry is held to:
      * ``"transfer_free"`` — the program must run with zero host round
        trips (the steady-state tick contract);
      * ``"bucketed"``      — inputs must land on the pow2 shape-bucket
        rule (``repro_torch.core.batch``), the retrace-storm guard.
    """

    name: str
    build: Callable[[int, int], tuple]
    contracts: frozenset = frozenset({"transfer_free", "bucketed"})
    backend: Optional[str] = None        # owning BACKENDS key, if any


TRACE_SPECS: Dict[str, Callable[[], list]] = {}


def register_trace_spec(name: str):
    """Decorator registering a zero-arg function returning the
    ``TraceEntry`` list for one backend (or subsystem). The analysis
    toolkit discovers every traceable program through this registry:
    adding a backend without a trace spec is caught by its sweep
    test."""
    def deco(fn):
        if name in TRACE_SPECS:
            raise ValueError(f"trace spec {name!r} already registered")
        TRACE_SPECS[name] = fn
        return fn
    return deco


def trace_entries() -> list:
    """Every registered ``TraceEntry``, sorted by name. Importing
    ``repro_torch.api.backends`` (and ``repro_torch.analysis.entries``)
    populates the registry; this accessor only reads it."""
    out = []
    for name in sorted(TRACE_SPECS):
        out.extend(TRACE_SPECS[name]())
    return sorted(out, key=lambda e: e.name)


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
