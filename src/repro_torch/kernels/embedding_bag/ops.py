"""Wrapper of the embedding-bag kernel (``csrc/embedding_bag.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Kernel, check_tensor, stream_of
from repro_torch.kernels.embedding_bag.ref import ref_embedding_bag
from repro_torch.roofline.analysis import record_kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COMBINES = ("sum", "mean")
KERNEL = Kernel("embedding_bag", "embedding_bag",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag lookup: a [Vocab, D] table (float32 or bfloat16)
    and int32 [B, bag] indices, each in [0, Vocab), give [B, D] in the
    table dtype: each bag's rows summed in fp32, rounded once, and for
    ``mean`` divided by ``bag`` and rounded again. A CPU ``table`` runs
    the plain version; a CUDA one the kernel; a ``meta`` one (the
    dry-run) only the output's shape. Unlike the reference's wrapper,
    nothing is padded: the kernel has no bag tile. Each launch reports
    its bytes to the cost model (``roofline.analysis``): the indices,
    the gathered rows and the output, once each."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got "
                         f"{combine!r}")
    if indices.dim() != 2 or indices.shape[1] < 1:
        raise ValueError(f"indices must be [B, bag] with bag >= 1, got "
                         f"{tuple(indices.shape)}")
    if table.device.type == "cpu":
        return ref_embedding_bag(table, indices, combine)
    b, bag = indices.shape
    row = table.shape[1] * table.element_size()
    nbytes = b * bag * (4 + row) + b * row
    if table.device.type == "meta":
        record_kernel("embedding_bag", nbytes)
        return table.new_empty((b, table.shape[1]))
    check_tensor("table", table, tuple(DTYPES), 2)
    check_tensor("indices", indices, (torch.int32,), 2)
    if indices.device != table.device:
        raise ValueError("indices must be on the table's device")
    out = torch.empty((b, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    with torch.cuda.device(table.device):
        KERNEL.launch(table.data_ptr(), indices.data_ptr(), out.data_ptr(),
                      b, bag, table.shape[1], DTYPES[table.dtype],
                      int(combine == "mean"), stream_of(table))
    record_kernel("embedding_bag", nbytes)
    return out
