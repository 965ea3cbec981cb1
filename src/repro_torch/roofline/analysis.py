"""The roofline of the port on one H100: the bound model of ``PERF.md``
§3 and a cost model that counts a program's work as it runs. The
counterpart of both ``repro.roofline.analysis`` and
``repro.roofline.hlo_cost``.

Hardware constants: an H100 SXM, 3.35 TB/s of device memory, 989
TFLOP/s of dense bf16 on the tensor cores, 67 TFLOP/s of fp32 outside
them.

* ``bound_ms`` / ``bound``: the least time of a call that must move
  ``nbytes`` and do ``nops`` fp32 operations (``chip_smoke.py``'s rows).

* ``cost(fn, *args)`` runs ``fn`` once under ``FlopCounterMode``
  together with a ``TorchDispatchMode`` that counts every aten op's
  bytes. In eager PyTorch every op is a round trip through device
  memory, so the sum is this program's traffic, not a guess at fusion
  boundaries; and every executed op is counted, so loop trip counts
  (a fixpoint's sweeps, accumulation steps, a remat recompute) are in
  it: getting them right is ``hlo_cost``'s whole purpose, and here the
  run does it. An op's bytes are its tensor inputs read once and its
  outputs written once, with three exceptions: views and allocations
  move nothing; a gather (``index``, ``index_select``, ``embedding``,
  ``gather``) reads its indices and as many source bytes as it writes;
  a scatter (``index_add``, ``index_put``, ``scatter*``, ``index_copy``)
  reads its indices and updates and reads and writes as many
  destination bytes as the updates hold (plus a full copy when it is
  not in place). A hand-written kernel is no aten op: its wrapper
  reports the work of each launch (``record_kernel``), on the card and
  on ``meta``. The work of the CC kernels (K1-K3) depends on sweeps
  that only a read-back would give, and no cost-modelled path runs
  them: they report nothing. Compute time is each dtype's FLOPs over
  its peak: bf16 and fp16 at the tensor-core rate, everything else at
  fp32's (TF32 is off).

* ``Roofline`` keeps the reference's field names and ``as_dict`` keys,
  which ``benchmarks/report.py`` reads. One card has no collectives, so
  ``wire_gbytes_per_chip``, ``t_collective`` and ``collectives`` are 0
  and empty. The ``hlo_*`` fields hold the cost model's counts from the
  dispatch trace: there is no HLO.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense tensor-core peak
SECTOR = 32                        # bytes a random 4-byte read costs in DRAM
TENSOR_CORE_DTYPES = ("bfloat16", "float16")


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``nops`` fp32 operations outside the tensor cores, and which of the
    two bounds it."""
    by_bytes = bound_ms(nbytes)
    by_ops = nops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def peak_ops_per_s(dtype: str) -> float:
    return BF16_OPS_PER_S if dtype in TENSOR_CORE_DTYPES else FP32_OPS_PER_S


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cost:
    """The work one run did: FLOPs by dtype name, bytes moved, the aten
    ops counted, each hand-written kernel's launches, bytes and FLOPs
    (``{name: {"launches", "bytes", "flops"}}``), and the bytes and FLOPs
    done inside each ``torch.profiler.record_function`` range
    (``{name: {"bytes", "flops"}}``; nested ranges each count)."""

    flops: dict = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    ranges: dict = dataclasses.field(default_factory=dict)
    _open: list = dataclasses.field(default_factory=list, repr=False)

    def add(self, nbytes: float, dtype: str, flops: float) -> None:
        """Count one op's (or launch's) work, in every open range too."""
        self.bytes += nbytes
        self.add_flops(dtype, flops)
        for name in self._open:
            r = self.ranges.setdefault(name, {"bytes": 0.0, "flops": 0.0})
            r["bytes"] += nbytes
            r["flops"] += flops

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def t_compute(self) -> float:
        """Seconds: each dtype's FLOPs over its peak."""
        return sum(f / peak_ops_per_s(dt) for dt, f in self.flops.items())

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    def bound_ms(self) -> float:
        """The least time (ms) of the run: the larger of its two terms."""
        return max(self.t_compute, self.t_memory) * 1e3

    def add_flops(self, dtype: str, flops: float) -> None:
        if flops:
            self.flops[dtype] = self.flops.get(dtype, 0.0) + float(flops)


_ACTIVE: list = []                 # the Costs of the cost() calls running


def record_kernel(name: str, nbytes: float, flops: float = 0.0,
                  dtype: str = "float32") -> None:
    """A hand-written kernel's launch, reported by its wrapper: adds the
    launch's bytes and FLOPs to every cost model running (none: a no-op).
    """
    for c in _ACTIVE:
        c.add(nbytes, dtype, flops)
        k = c.kernels.setdefault(name, {"launches": 0, "bytes": 0.0,
                                        "flops": 0.0})
        k["launches"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops


_GATHERS = ("index", "index_select", "embedding", "gather", "take")
_SCATTERS = ("index_add", "index_add_", "index_put", "index_put_",
             "_index_put_impl_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_copy", "index_copy_")
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "set_", "resize_", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "record_stream", "_has_compatible_shallow_copy_type")
_WRITE_ONLY = ("fill_", "zero_", "normal_", "uniform_", "random_")


def _tensors(tree) -> list:
    """The distinct tensors of an op's arguments or outputs (tuples,
    lists and dicts walked)."""
    import torch
    seen, out, stack = set(), [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op moves (see the module docstring)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _FREE:
        return 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    out_ids = {id(t) for t in outs}
    reads = [t for t in ins if id(t) not in out_ids]
    if name in _GATHERS:
        idx = [t for t in reads if t is not args[0]]
        return _nbytes(idx) + 2 * _nbytes(outs)
    if name in _SCATTERS:
        dest = args[0]
        rest = [t for t in reads if t is not dest]
        upd = max((t for t in rest if t.dtype == dest.dtype),
                  key=lambda t: t.numel(), default=None)
        small = [t for t in rest if t is not upd]
        moved = _nbytes(small) + 3 * (_nbytes([upd]) if upd is not None
                                      else 0)
        if name.endswith("_"):
            return moved
        return moved + 2 * _nbytes([dest])
    if name in _WRITE_ONLY:
        return _nbytes(outs)
    if name == "copy_":
        return _nbytes(reads) + _nbytes(outs)
    return _nbytes(ins) + _nbytes(outs)     # in place: self read and written


def _flop_dtype(args) -> str:
    for t in _tensors(args):
        if t.is_floating_point():
            return str(t.dtype).replace("torch.", "")
    return "float32"


_FUNCTIONAL: dict = {}            # OpOverload -> no aliased or mutated args


def _functional(func) -> bool:
    """Whether ``func`` returns fresh tensors and writes none of its
    arguments (what may be memoized on ``meta``)."""
    if func not in _FUNCTIONAL:
        schema = func._schema
        _FUNCTIONAL[func] = not func.is_view and not any(
            r.alias_info is not None for r in schema.returns) and not any(
            a.alias_info is not None and a.alias_info.is_write
            for a in schema.arguments)
    return _FUNCTIONAL[func]


def _meta_key(args):
    """A signature of an op's arguments on ``meta`` (tensors by shape,
    stride and dtype, sequences walked, anything else as itself), or
    None when a tensor is not on ``meta``."""
    import torch
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                return None
            out.append((x.shape, x.stride(), x.dtype))
        elif isinstance(x, (list, tuple)):
            k = _meta_key(x)
            if k is None:
                return None
            out.append(k)
        else:
            out.append(x)
    return tuple(out)


def _spec(out):
    """How to rebuild ``out`` (a ``meta`` tensor or a sequence of them),
    or None (an output on a real device is never memoized: a factory op
    has no tensor argument to tell its device by)."""
    import torch
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.is_meta else None
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(t, torch.Tensor) and t.is_meta for t in out):
        return (type(out), [_spec(t) for t in out])
    return None


def _rebuild(spec):
    """Fresh ``meta`` outputs of ``spec``'s layout, made below the
    dispatch modes (nothing to count)."""
    import torch
    if isinstance(spec[0], type):
        return spec[0](_rebuild(s) for s in spec[1])
    shape, stride, dtype = spec
    with torch._C._ExcludeDispatchKeyGuard(
            torch._C.DispatchKeySet(torch._C.DispatchKey.Python)):
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="meta")


def cost(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), Cost)``: one run of ``fn`` with its
    work counted (see the module docstring). Runs on any device:
    ``meta`` tensors count a program without allocating it. On
    ``meta`` a functional op is memoized by its arguments' shapes,
    strides and dtypes (the same op on the same signature does the same
    work): a repeat gives fresh outputs of the first call's layout and
    counts the first call's bytes and FLOPs, without running the op's
    shape function again. Layers and microbatches repeat their ops, so
    this is what makes a full-depth dry-run quick. An op with no FLOP
    formula in ``FlopCounterMode``'s registry runs below it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    c = Cost()
    memo: dict = {}
    python_key = torch._C.DispatchKeySet(torch._C.DispatchKey.Python)

    class _Bytes(TorchDispatchMode):
        def __init__(self, counter):
            super().__init__()
            self.counter = counter

        def __torch_dispatch__(self, func, types, fargs=(), fkwargs=None):
            fkwargs = fkwargs or {}
            c.ops += 1
            if func.namespace == "profiler":     # a record_function range
                out = func(*fargs, **fkwargs)
                if func.__name__.startswith("_record_function_enter"):
                    c._open.append(fargs[0])
                elif c._open:
                    c._open.pop()
                return out
            if func.is_view:           # moves nothing, no FLOPs
                with torch._C._ExcludeDispatchKeyGuard(python_key):
                    return func(*fargs, **fkwargs)
            key = hit = None
            if _functional(func):
                key = _meta_key(fargs)
                if key is not None and fkwargs:
                    kw = _meta_key(tuple(fkwargs.values()))
                    key = None if kw is None else \
                        (key, tuple(fkwargs), kw)
            if key is not None:
                key = (func, key)
                try:
                    hit = memo.get(key)
                except TypeError:      # an argument that does not hash
                    key = None
            if hit is not None:
                spec, nbytes, dtype, flops = hit
                out = _rebuild(spec)
            else:
                dtype, flops = "float32", 0.0
                if func.overloadpacket in flop_registry:
                    before = self.counter.get_total_flops()
                    out = func(*fargs, **fkwargs)
                    flops = self.counter.get_total_flops() - before
                    dtype = _flop_dtype(fargs)
                else:              # no FLOP formula: skip the counter
                    with torch._C._ExcludeDispatchKeyGuard(python_key):
                        out = func(*fargs, **fkwargs)
                nbytes = op_bytes(func, fargs, fkwargs, out)
                spec = _spec(out) if key is not None else None
                if spec is not None:
                    memo[key] = (spec, nbytes, dtype, flops)
            c.add(nbytes, dtype, flops)
            return out

    counter = FlopCounterMode(display=False)
    _ACTIVE.append(c)
    try:
        with counter, _Bytes(counter):
            result = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(c)
    return result, c


# ---------------------------------------------------------------------------
# The reference's record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    hlo_gflops_per_chip: float
    hlo_gbytes_per_chip: float
    wire_gbytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    collectives: dict
    model_gflops: float = 0.0     # 6·N·D (analytic, global)

    @property
    def step_time(self) -> float:
        """Optimistic (max-of-terms) step-time bound."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def useful_flop_ratio(self) -> float:
        total = self.hlo_gflops_per_chip * self.chips
        return self.model_gflops / total if total else 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "bottleneck": self.bottleneck,
            "step_time_bound_s": self.step_time,
            "useful_flop_ratio": round(self.useful_flop_ratio(), 4),
        }


def analyze(c: Cost, *, arch: str, shape: str,
            model_flops: float = 0.0) -> Roofline:
    """The roofline terms of one card from a counted run."""
    terms = {"compute": c.t_compute, "memory": c.t_memory,
             "collective": 0.0}
    return Roofline(
        arch=arch, shape=shape, chips=1,
        hlo_gflops_per_chip=c.total_flops / 1e9,
        hlo_gbytes_per_chip=c.bytes / 1e9,
        wire_gbytes_per_chip=0.0,
        t_compute=c.t_compute, t_memory=c.t_memory, t_collective=0.0,
        bottleneck=max(terms, key=terms.get), collectives={},
        model_gflops=model_flops / 1e9)
