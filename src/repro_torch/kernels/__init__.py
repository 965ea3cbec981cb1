"""Hand-written Hopper kernels for the port's hot spots: connected
components (cc_fused, hook, multi_jump), the recsys lookup
(embedding_bag, segment_reduce) and LM prefill attention
(flash_attention).

Each kernel package ships:
  * ``csrc/<name>.cu`` — the CUDA C++ kernel for ``sm_90a`` behind a
    plain C entry point that returns the CUDA error code;
  * ``<name>/ops.py`` — the wrapper: checks device, dtype, shape and
    contiguity, allocates outputs and scratch with torch, launches on
    the current stream, raises on a CUDA error and counts its launches.
    A tensor on the CPU goes to the plain version instead; a CUDA
    tensor always goes to the kernel;
  * ``<name>/ref.py`` — the plain PyTorch version of the same function.

Kernel inventory:
  * cc_fused   — the WHOLE Fig. 4 segment scan (every hook round and
                 every compress sweep) in one cooperative launch, the
                 dynamic engine's id-recording scan (the spanning forest
                 recorded as it hooks) likewise, and with a batch axis
                 the scan of a whole shape bucket of graphs (the
                 batched engine);
  * hook       — hook (gather, root chase, scatter-min): every edge
                 from one π snapshot on every SM, and edge tiles in
                 ascending order in one block;
  * multi_jump — blocked pointer jumping with continuous write-back,
                 vertex tiles in ascending order (one sweep), and the
                 compress to the fixpoint on every SM, each vertex
                 chased to its root;
  * embedding_bag  — gather rows of a [Vocab, D] table by [B, bag]
                     indices and sum or mean each bag (fp32 sum, one
                     rounding to the table dtype);
  * segment_reduce — sum / min / max of [N, D] rows into [S, D] by
                     int32 segment ids, identity-initialised: sorted
                     ids in one pass that owns each output row,
                     unsorted ids through atomics on an fp32 scratch;
  * flash_attention — online-softmax grouped-query attention (causal,
                      sliding window, logit softcap), fp32 accumulation:
                      a warp-specialised wgmma body with a TMA ring for
                      bfloat16 at head dim 64-256, an fp32-FMA body for
                      the rest.

``autograd.py`` pairs the two recsys kernels for training: the
lookup's table gradient is a segment sum, the segment sum's gradient a
lookup.

Build: ``nvcc`` compiles each source into its own shared library (one
process per source, all started together) under
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the
repository root, at first use; ``ctypes`` loads them. Nothing is built
or loaded when this package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCES = ("cc_fused", "hook", "multi_jump", "embedding_bag",
           "segment_reduce", "flash_attention")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all in parallel. Returns ``{"seconds": wall time,
    "ptxas": {name: register/shared-memory report}}`` for the sources
    built now (each report is also kept beside its library, see
    ``ptxas_report``); raises with the compiler's output if any source
    fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode == 0:
            (out / f"lib{name}.ptxas.txt").write_text(text)
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``csrc/<name>.cu``
    (registers, shared memory, spills of each kernel), building it
    first if needed."""
    report = build_dir() / f"lib{name}.ptxas.txt"
    if not report.exists():
        build()
    return report.read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use)."""
    if name not in _libs:
        lib = build_dir() / f"lib{name}.so"
        if not lib.exists():
            build()
        cdll = ctypes.CDLL(str(lib))
        cdll.repro_cuda_error_string.argtypes = [ctypes.c_int]
        cdll.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = cdll
    return _libs[name]


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launch(*args)`` calls the entry point (arguments as declared in
    ``argtypes``: pointers and the stream as ``c_void_p``, sizes as
    ``c_int``/``c_longlong``), raises if it returns a CUDA error, and
    adds one to ``launches`` only for a launch that was accepted."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library(self.source).repro_cuda_error_string(err)
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: "
                               f"{msg.decode()}")
        self.launches += 1


class Bodies:
    """The launches of a kernel's bodies (``Kernel``s of one source) as
    one count: reading gives the sum, setting it to 0 resets each."""

    def __init__(self, *bodies: Kernel):
        self.bodies = bodies

    @property
    def launches(self) -> int:
        return sum(b.launches for b in self.bodies)

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError("the launch count can only be reset to 0")
        for b in self.bodies:
            b.launches = 0


def check_tensor(name: str, t, dtypes: tuple, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dimensions."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_int32(name: str, t, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous int32 CUDA tensor of ``ndim``
    dimensions (what the CC kernels take)."""
    import torch
    check_tensor(name, t, (torch.int32,), ndim)


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s device, read
    without building a ``torch.cuda.Stream`` (which costs a few
    microseconds a call, as much as a small kernel runs)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())
