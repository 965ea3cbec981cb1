from repro_torch.kernels.hook.ops import hook_edges_pallas
