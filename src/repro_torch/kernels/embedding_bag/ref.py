"""Plain PyTorch version of the embedding-bag kernel."""
from __future__ import annotations

import torch


def ref_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                      combine: str = "sum") -> torch.Tensor:
    """[Vocab, D] table, [B, bag] indices -> [B, D] in the table dtype:
    the bag's rows summed in fp32 and rounded once; ``mean`` divides
    that rounded sum by ``bag`` and rounds again, as the reference's
    kernel does."""
    agg = table[indices.long()].float().sum(1).to(table.dtype)
    if combine == "mean":
        agg = agg / indices.shape[1]
    return agg
