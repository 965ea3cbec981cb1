"""The plain reference that decides ``correct``: connected components of
an undirected edge list, as canonical min-id labels.

Plain PyTorch, independent of the program under test: it imports only
``torch``. Every round hooks each edge's larger root under its smaller
one with one ``scatter_reduce`` (``amin``), then jumps pointers until
every vertex points at its root. A root only ever points at a smaller
id, so each component's root is its minimum vertex, which is the label
the program promises. It ends after the first round in which no edge
joins two trees.

``stop_short`` returns the labels from before the last hooking round
that changed anything: an answer from before convergence, the control
of the comparison.
"""
from __future__ import annotations

import torch


def _compress(parent: torch.Tensor) -> torch.Tensor:
    """Jump pointers until every vertex points at a root."""
    while True:
        grand = parent[parent]
        if torch.equal(grand, parent):
            return parent
        parent = grand


def cc_labels(edges: torch.Tensor, num_nodes: int, *,
              stop_short: bool = False,
              block_rows: int = 1 << 25) -> tuple[torch.Tensor, int]:
    """``(labels, rounds)``: int32 [num_nodes] labels, each vertex's
    component minimum, and the hooking rounds that changed something
    (with ``stop_short``, the labels before the last of those rounds).

    ``edges`` is an int [E, 2] tensor on any device; the work runs
    there, ``block_rows`` edges at a time, so that the int64 copies of a
    large edge list never exist whole."""
    dev = edges.device
    parent = torch.arange(num_nodes, dtype=torch.int64, device=dev)
    before, rounds = parent, 0
    while True:
        # every block reads the roots as the round found them and writes
        # only to those roots, so no block undoes another's hook
        hooked = parent.clone()
        changed = False
        for lo_row in range(0, edges.shape[0], block_rows):
            blk = edges[lo_row:lo_row + block_rows].long()
            ru, rv = parent[blk[:, 0]], parent[blk[:, 1]]
            lo, hi = torch.minimum(ru, rv), torch.maximum(ru, rv)
            live = lo != hi
            if bool(live.any()):
                changed = True
                hooked.scatter_reduce_(0, hi[live], lo[live], "amin")
        if not changed:
            break
        # a hooked root can point at a root hooked in the same round
        before, parent = parent, _compress(hooked)
        rounds += 1
    return (before if stop_short else parent).to(torch.int32), rounds


def mismatches(labels: torch.Tensor, want: torch.Tensor) -> int:
    """The vertices whose label differs from the reference's (a label
    vector of the wrong length counts every vertex)."""
    if labels.shape != want.shape:
        return int(want.numel())
    return int((labels.to(want.device).to(torch.int32) != want).sum())
