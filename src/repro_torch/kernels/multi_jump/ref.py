"""Plain PyTorch versions of the Multi-Jump kernel."""
from __future__ import annotations

import torch


def ref_full_compress(pi: torch.Tensor) -> torch.Tensor:
    """Fixed point of pointer jumping: every vertex points at its root."""
    while True:
        nxt = pi[pi]
        if bool((nxt == pi).all()):
            return nxt
        pi = nxt


def ref_multi_jump_sweep(pi: torch.Tensor, tile: int, rounds: int
                         ) -> torch.Tensor:
    """ONE blocked sweep in the kernel's order: vertex tiles ascending,
    each chased ``rounds`` levels with continuous write-back."""
    pi = pi.clone()
    for start in range(0, pi.shape[0], tile):
        t = pi[start:start + tile]
        for _ in range(rounds):
            t = pi[t]
            pi[start:start + tile] = t
    return pi


def ref_multi_jump_sweeps(pi: torch.Tensor, tile: int, rounds: int,
                          max_sweeps: int) -> torch.Tensor:
    """Blocked sweeps until one changes nothing, at most ``max_sweeps``
    (the kernel's ``full_compress`` mode)."""
    for _ in range(max_sweeps):
        nxt = ref_multi_jump_sweep(pi, tile, rounds)
        changed = bool((nxt != pi).any())
        pi = nxt
        if not changed:
            break
    return pi
