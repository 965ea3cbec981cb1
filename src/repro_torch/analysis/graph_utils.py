"""Run-time graph plumbing shared by every checker pass, the port's
counterpart of ``repro.analysis.jaxpr_utils``.

Torch has no jaxpr, so an entry is recorded as it runs:

* ``trace(entry, bucket, seed, device)`` builds the entry at
  ``bucket`` = (|V|, |E|), makes real inputs from its ``meta`` example
  arguments (values drawn from a numpy generator inside each
  ``VarInfo`` range; a [V] id array ranging over [0, V - 1] is drawn as
  a parent forest, each value at most its index, so that
  pointer-jumping programs reach their fixpoint), and runs it once
  under two modes stacked:

  * a ``TorchFunctionMode`` that records host reads (``item``,
    ``tolist``, ``numpy``, ``cpu``, ``to`` from a card onto the CPU,
    ``__bool__``, ``__int__``, ``__index__``, ``__float__``,
    ``__array__``; on the CPU a ``to`` onto it is no copy and cannot be
    told from one that follows the data's device, so only a card's run
    records it) and
    tensors built from host data (``torch.tensor``, ``as_tensor``,
    ``asarray``, ``from_numpy``, and on a card a copy from the CPU);
  * a ``TorchDispatchMode`` that records each aten op: its inputs and
    outputs (tensors by serial number, with dtype and shape), its
    scalar arguments, and, for the ops a pass may anchor a finding at
    (``SITED``), the ``src/repro_torch`` file:line that called it.

  The result is a straight-line record with loops unrolled by the run:
  this port's counterpart of a jaxpr. An entry that raises is recorded
  as a ``TraceFailure``, which the transfer pass reports.

* ``untraced()`` pauses the recording: an entry builds its engine's
  state under it (an insert before the delete it is about), so only the
  program the entry names is held to its contracts.

* A tensor's serial number rides on the tensor object
  (``_analysis_serial``): an in-place op's output keeps its input's
  serial, and every view or fresh output gets a new one. A tensor first
  seen as an input (state made before the record, or under
  ``untraced``) gets one then, with no provenance.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.graphs.device import resolve_device

HOST_READS = ("item", "tolist", "numpy", "cpu", "to", "__bool__",
              "__int__", "__index__", "__float__", "__array__")
HOST_PUTS = ("tensor", "as_tensor", "asarray", "from_numpy")
# the ops a pass may anchor a finding at: only these get a call site
# (a frame walk an op is the recorder's largest cost)
SITED = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "_to_copy",
    "sum", "nonzero", "masked_select", "unique", "_unique", "_unique2",
    "unique_consecutive", "unique_dim", "unique_dim_consecutive",
    "bincount", "_local_scalar_dense", "repeat_interleave", "index",
    "index_put", "index_put_", "_index_put_impl_"})
UNBOUNDED = (0, 1023)            # the draw of an integer with no range
_ATTR = "_analysis_serial"
_SERIALS = itertools.count(1)
_PAUSED = [0]
_RECORDER = "/repro_torch/analysis/graph_utils.py"


def serial(t: torch.Tensor) -> int:
    """The tensor's serial number (assigned at first sight)."""
    s = getattr(t, _ATTR, None)
    if s is None:
        s = next(_SERIALS)
        setattr(t, _ATTR, s)
    return s


@contextlib.contextmanager
def untraced():
    """Run the body without recording it (an entry's setup). On a card
    it also pauses CUDA's sync debug mode, so a count of the entry's
    synchronizing calls sees what the record sees."""
    sync_mode = torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_initialized() else 0
    if sync_mode:
        torch.cuda.set_sync_debug_mode(0)
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1
        if sync_mode:
            torch.cuda.set_sync_debug_mode(sync_mode)


def call_site() -> tuple[Optional[str], Optional[int]]:
    """(repo-relative file, line) of the innermost frame under
    ``src/repro_torch`` (the recorder's own frames skipped)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        idx = name.rfind("/repro_torch/")
        if idx >= 0 and not name.endswith(_RECORDER):
            return "src" + name[idx:], f.f_lineno
        f = f.f_back
    return None, None


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument or output of a recorded op."""

    serial: int
    dtype: torch.dtype
    shape: tuple
    device: str


@dataclasses.dataclass
class OpRecord:
    """One aten op: ``name`` is its overload packet (``mul``, ``add_``),
    ``args`` / ``kwargs`` hold a ``Ref`` per tensor, a tuple per list
    and the value of anything else."""

    name: str
    overload: str
    args: tuple
    kwargs: dict
    outs: tuple                    # Refs of the tensor outputs
    file: Optional[str]
    line: Optional[int]
    # CPU tensors the op copies onto its card (a CPU value of an index
    # write, say; a CPU scalar of a pointwise op is read on the host)
    host_copies: int = 0

    def tensor_args(self) -> list:
        """Every input ``Ref``, positional and keyword, lists flattened."""
        out = []

        def walk(x):
            if isinstance(x, Ref):
                out.append(x)
            elif isinstance(x, tuple):
                for y in x:
                    walk(y)
        for a in self.args:
            walk(a)
        for a in self.kwargs.values():
            walk(a)
        return out


@dataclasses.dataclass
class HostEvent:
    """A host read of a tensor (``kind`` "read") or a tensor built from
    host data (``kind`` "put")."""

    kind: str
    method: str
    device: str
    numel: int
    nbytes: int
    file: Optional[str]
    line: Optional[int]
    iota: bool = False             # a put whose values are 0, 1, ... n-1


@dataclasses.dataclass
class Record:
    ops: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ArgRecord:
    """One flat argument of the run: a tensor (``ref``) or a Python
    scalar (``value``)."""

    ref: Optional[Ref] = None
    value: Any = None


@dataclasses.dataclass
class TraceFailure:
    exc_type: str
    message: str


@dataclasses.dataclass
class TracedEntry:
    entry: Any                     # the api.registry.TraceEntry
    bucket: tuple                  # (num_nodes, num_edges)
    device: str                    # the device type the entry ran on
    record: Record
    args: list                     # ArgRecord per flat argument
    arg_info: list                 # VarInfo per flat argument
    failure: Optional[TraceFailure] = None

    @property
    def name(self) -> str:
        return self.entry.name


def _device_type(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "meta" if t.is_meta else t.device.type


def _ref(x):
    if isinstance(x, torch.Tensor):
        s = getattr(x, _ATTR, None)
        return Ref(serial(x) if s is None else s, x.dtype, x.shape,
                   _device_type(x))
    if isinstance(x, (list, tuple)):
        return tuple([_ref(y) for y in x])
    return x


def _outs(out) -> tuple:
    if isinstance(out, torch.Tensor):
        return (_ref(out),)
    if isinstance(out, (list, tuple)):
        return tuple(r for o in out for r in _outs(o))
    return ()


_EXPLICIT_COPIES = ("_to_copy", "lift_fresh", "lift_fresh_copy")


def _host_copies(func, op: OpRecord) -> int:
    """How many CPU tensors ``op`` moves onto a card: a CPU argument of
    an op that runs there, but for a 0-d one of a pointwise op (read on
    the host as a scalar). ``_to_copy`` is the explicit put a host
    event records already."""
    refs = op.tensor_args()
    cpu = [r for r in refs if r.device == "cpu"]
    if not cpu or all(r.device == "cpu" for r in refs + list(op.outs)):
        return 0
    pointwise = torch.Tag.pointwise in func.tags
    return sum(not (pointwise and len(r.shape) == 0) for r in cpu)


class _Ops(TorchDispatchMode):
    def __init__(self, record: Record):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _PAUSED[0]:
            return func(*args, **kwargs)
        ins, kw = _ref(tuple(args)), {k: _ref(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        file, line = call_site() if name in SITED else (None, None)
        op = OpRecord(name, func._overloadname, ins, kw, _outs(out), file,
                      line)
        if name not in _EXPLICIT_COPIES:
            op.host_copies = _host_copies(func, op)
        self.record.ops.append(op)
        return out


def _target_device(args, kwargs) -> Optional[str]:
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type
        if isinstance(a, torch.Tensor):
            return a.device.type
    return None


def _is_iota(data) -> bool:
    if not isinstance(data, (np.ndarray, range)):
        return False
    arr = np.asarray(data)
    return (arr.ndim == 1 and arr.dtype.kind in "iu" and
            bool(np.array_equal(arr, np.arange(arr.shape[0]))))


class _Host(TorchFunctionMode):
    def __init__(self, record: Record, device: str):
        super().__init__()
        self.record = record
        self.device = device

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _PAUSED[0]:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in HOST_READS and args and isinstance(args[0], torch.Tensor):
            t = args[0]
            if name != "to" or (t.device.type != "cpu" and _target_device(
                    args, kwargs) == "cpu"):
                self._event("read", name, t)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            if name in HOST_PUTS and not (args and isinstance(
                    args[0], torch.Tensor)):
                self._event("put", name, out,
                            iota=out.numel() > 8 and _is_iota(args[0]))
            elif name == "to" and args and isinstance(args[0], torch.Tensor) \
                    and args[0].device.type == "cpu" \
                    and out.device.type != "cpu":
                self._event("put", name, out)
        return out

    def _event(self, kind: str, method: str, t: torch.Tensor,
               iota: bool = False) -> None:
        file, line = call_site()
        self.record.host.append(HostEvent(
            kind, method, t.device.type, t.numel(),
            t.numel() * t.element_size(), file, line, iota))


def _draw(arg, info, rng: np.random.Generator, device: torch.device):
    """A real input for one example argument (see the module
    docstring); a Python scalar passes as given."""
    if not isinstance(arg, torch.Tensor):
        return arg
    shape, dtype = tuple(arg.shape), arg.dtype
    if dtype == torch.bool:
        vals = rng.random(shape) < (0.9 if info.mask else 0.5)
    elif dtype.is_floating_point:
        vals = rng.standard_normal(shape)
    else:
        lo, hi = info.range if info.range is not None else UNBOUNDED
        vals = rng.integers(lo, hi + 1, size=shape, dtype=np.int64)
        if len(shape) == 1 and lo == 0 and shape[0] == hi + 1:
            vals = np.minimum(vals, np.arange(shape[0]))
    return torch.as_tensor(vals).to(dtype).to(device)


def trace(entry, bucket: tuple, seed: int = 0, device=None,
          runner=None) -> TracedEntry:
    """Run ``entry`` once at ``bucket`` = (V, E) on ``device`` (CUDA
    unless given; raises without CUDA unless ``device="cpu"``),
    recording it (see the module docstring). ``runner(run)``, when
    given, calls the recorded run (a zero-argument function) inside
    whatever it measures it with."""
    dev = resolve_device(device)
    v, e = bucket
    fn, args, info = entry.build(v, e)
    if len(args) != len(info):
        raise ValueError(f"{entry.name}: {len(args)} arguments, "
                         f"{len(info)} VarInfo")
    rng = np.random.default_rng(seed)
    real = [_draw(a, i, rng, dev) for a, i in zip(args, info)]
    flat = [ArgRecord(ref=_ref(a)) if isinstance(a, torch.Tensor)
            else ArgRecord(value=a) for a in real]
    record = Record()
    failure = None
    def run():
        with _Host(record, dev.type), _Ops(record):
            fn(*real)
    try:
        run() if runner is None else runner(run)
    except Exception as err:  # noqa: BLE001 — the failure IS the datum
        failure = TraceFailure(type(err).__name__, str(err))
    return TracedEntry(entry, bucket, dev.type, record, flat, list(info),
                       failure)


def repo_root() -> Path:
    """The repository root (…/src/repro_torch/analysis → three up)."""
    return Path(__file__).resolve().parents[3]
