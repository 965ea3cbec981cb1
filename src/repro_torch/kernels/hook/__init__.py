from repro_torch.kernels.hook.ops import (hook_edges_pallas,
                                         hook_edges_snapshot)
