from repro_torch.kernels.cc_fused.ops import fused_segment_scan
