"""Wrapper of the fused segment-scan kernel (``csrc/cc_fused.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rounds import compress_fuel
from repro_torch.kernels import Kernel, check_int32, stream_of
from repro_torch.kernels.cc_fused.ref import ref_segment_scan

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("cc_fused", "cc_fused_scan",
                [_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P])


def fused_segment_scan(pi: torch.Tensor, segments: torch.Tensor,
                       true_counts: torch.Tensor, *, lift_steps: int = 2,
                       fuel: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Fig. 4 segment scan in ONE kernel launch.

    Args:
      pi: int32 [V] parent workspace (not modified).
      segments: int32 [S, seg, 2] edge segments (pad tail with (0, 0)).
      true_counts: int32 [S] per-segment true edge counts; slots past
        them are masked to (0, 0) no-ops.
      fuel: compress fuel per segment; None derives ``compress_fuel(V)``.

    Returns:
      (pi', sweeps int32 [S]) — sweeps feed jump billing outside.
      A CPU ``pi`` runs the plain version; a CUDA one the kernel.
    """
    if fuel is None:
        fuel = compress_fuel(pi.shape[0])
    true_counts = true_counts.to(torch.int32)
    if pi.device.type == "cpu":
        return ref_segment_scan(pi, segments, true_counts,
                                lift_steps=lift_steps, fuel=fuel)
    check_int32("pi", pi, 1)
    check_int32("segments", segments, 3)
    check_int32("true_counts", true_counts, 1)
    num_segments, seg, two = segments.shape
    if two != 2 or true_counts.shape[0] != num_segments:
        raise ValueError(f"segments {tuple(segments.shape)} and true_counts "
                         f"{tuple(true_counts.shape)} do not match")
    if not (segments.device == pi.device == true_counts.device):
        raise ValueError("pi, segments and true_counts must share a device")
    out = pi.clone()
    sweeps = torch.zeros(num_segments, dtype=torch.int32, device=pi.device)
    if pi.shape[0] == 0 or num_segments == 0 or seg == 0:
        return out, sweeps
    scratch = torch.empty_like(pi)
    hilo = torch.empty((seg, 2), dtype=torch.int32, device=pi.device)
    flags = torch.zeros(num_segments * fuel, dtype=torch.int32,
                        device=pi.device)
    with torch.cuda.device(pi.device):
        KERNEL.launch(segments.data_ptr(), true_counts.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), hilo.data_ptr(),
                      flags.data_ptr(), sweeps.data_ptr(), pi.shape[0],
                      num_segments, seg, lift_steps, fuel, stream_of(pi))
    return out, sweeps
