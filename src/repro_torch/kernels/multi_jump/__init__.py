from repro_torch.kernels.multi_jump.ops import full_compress, multi_jump
