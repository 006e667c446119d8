"""The plain reference: a level-synchronous top-down BFS in plain PyTorch
over the benchmark's own CSR, and the comparison that decides ``correct``.

It imports nothing of the program and reads nothing the program made: it
runs on the arrays ``bfsbench.kron`` built.  Levels are int32 hop counts
from the root, ``INF`` where the root does not reach.

``truncate`` builds the control: the same BFS with every level's
expansion cut at that many arcs and the rest dropped, with no retry.  It
breaks the configuration's guarantee that every level is the exact hop
distance however large the frontier grows, which is the shortcut an
engine with a fixed edge budget would take if it left out its overflow
retry.
"""
from __future__ import annotations

import numpy as np
import torch

INF = 1 << 30

# Arcs expanded in one block: bounds the temporaries of the largest level.
_BLOCK_ARCS = 1 << 26


def _expand(indptr: torch.Tensor, indices: torch.Tensor,
            frontier: torch.Tensor, limit: int | None):
    """The neighbours of ``frontier`` (int64 ids), in blocks of at most
    ``_BLOCK_ARCS`` arcs; with ``limit``, only the first ``limit`` arcs of
    the level."""
    starts = indptr[frontier]
    deg = indptr[frontier + 1] - starts
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if cum.numel() else 0
    if limit is not None:
        total = min(total, int(limit))
    lo_arc = 0
    while lo_arc < total:
        hi_arc = min(lo_arc + _BLOCK_ARCS, total)
        pos = torch.arange(lo_arc, hi_arc, device=indptr.device)
        owner = torch.searchsorted(cum, pos, right=True)
        first = cum[owner] - deg[owner]
        yield indices[starts[owner] + (pos - first)].to(torch.int64)
        lo_arc = hi_arc


def bfs_levels(indptr: torch.Tensor, indices: torch.Tensor, root: int,
               truncate: int | None = None) -> torch.Tensor:
    """Hop distance of every vertex from ``root`` (int32[n], ``INF`` where
    unreached), on the arrays' device."""
    n = int(indptr.numel()) - 1
    dev = indptr.device
    level = torch.full((n,), INF, dtype=torch.int32, device=dev)
    level[root] = 0
    frontier = torch.tensor([int(root)], dtype=torch.int64, device=dev)
    depth = 0
    while frontier.numel():
        for nbr in _expand(indptr, indices, frontier, truncate):
            nbr = nbr[level[nbr] == INF]
            level[nbr] = depth + 1
        depth += 1
        frontier = torch.nonzero(level == depth).squeeze(1)
    return level


def mismatches(indptr: torch.Tensor, indices: torch.Tensor, root: int,
               row: np.ndarray, truncate: int | None = None) -> int:
    """How many vertices of ``row`` (the program's answer for ``root``)
    differ from the reference's level."""
    want = bfs_levels(indptr, indices, root, truncate)
    got = torch.from_numpy(np.ascontiguousarray(row, dtype=np.int32)).to(
        want.device)
    if got.shape != want.shape:
        return int(want.numel())
    return int((got != want).sum())


def control_cap(arcs: int) -> int:
    """The control's per-level expansion cap: a sixteenth of the arcs."""
    return max(arcs // 16, 1)
