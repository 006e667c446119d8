"""Shared primitives of the batched engine (port of the shared half of
``repro.core.bfs_local``).

``LocalGraph`` (device tensors), the static-cap frontier compaction (P1),
the budgeted neighbour expansion (P2 gather), the ``SV_*`` statvec layout,
root validation, the TEPS numerator and the pure-Python oracle.  The
single-source ``BFSRunner`` of the reference is not ported yet.

None of the device functions here synchronises with the host: sizes come
from Python ints (caps and budgets), never from tensor values, so the
engine keeps its one-fetch-per-level protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import bitmap
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, edge_sources

INF = 1 << 30

# Layout of the per-level fused stats vector (int32[7]) every step returns:
# next-frontier stats for the Scheduler, this step's edge total + overflow
# flag, and the new-discovery popcount — ONE device->host transfer per level.
SV_NF, SV_MF, SV_MU, SV_NU, SV_TOTAL, SV_OVERFLOW, SV_COUNT = range(7)


@dataclasses.dataclass(frozen=True)
class LocalGraph:
    """Device-resident graph tensors (vertex space padded to words).

    Index tensors are int32 (graphs up to 2**31 edges), as in the
    reference; ``in_seg_first`` is bool.
    """

    n: int
    n_pad: int
    out_indptr: torch.Tensor    # int32[n_pad+1]
    out_indices: torch.Tensor   # int32[E]
    in_indptr: torch.Tensor
    in_indices: torch.Tensor
    out_src: torch.Tensor       # int32[E] edge-parallel CSR sources
    in_child: torch.Tensor      # int32[E] edge-parallel CSC rows (children)
    out_deg: torch.Tensor       # int32[n_pad] stored out-degrees
    in_deg: torch.Tensor        # int32[n_pad] stored in-degrees
    in_seg_first: torch.Tensor  # bool[E]  e starts a child's in-list
    in_seg_end: torch.Tensor    # int32[n_pad] last in-edge per child (-1: none)

    @property
    def device(self) -> torch.device:
        return self.out_indptr.device


FIELDS = ("out_indptr", "out_indices", "in_indptr", "in_indices", "out_src",
          "in_child", "out_deg", "in_deg", "in_seg_first", "in_seg_end")


def local_graph_arrays(csr: CSRGraph, csc: CSRGraph) -> dict:
    """The numpy arrays of every ``LocalGraph`` field (host side)."""
    n = csr.num_vertices
    n_pad = bitmap.num_words(n) * bitmap.WORD_BITS

    def pad_ptr(indptr):
        return np.concatenate(
            [indptr, np.full(n_pad - n, indptr[-1], dtype=indptr.dtype)])

    out_ptr = pad_ptr(csr.indptr)
    in_ptr = pad_ptr(csc.indptr)
    in_deg = np.diff(in_ptr)
    e_in = int(csc.indices.shape[0])
    in_first = np.zeros(e_in, dtype=bool)
    in_first[in_ptr[:-1][in_deg > 0]] = True
    in_end = np.where(in_deg > 0, in_ptr[1:] - 1, -1)
    return dict(
        out_indptr=out_ptr.astype(np.int32),
        out_indices=np.asarray(csr.indices, np.int32),
        in_indptr=in_ptr.astype(np.int32),
        in_indices=np.asarray(csc.indices, np.int32),
        out_src=edge_sources(csr),
        in_child=edge_sources(csc),
        out_deg=np.diff(out_ptr).astype(np.int32),
        in_deg=in_deg.astype(np.int32),
        in_seg_first=in_first,
        in_seg_end=in_end.astype(np.int32),
    )


def build_local_graph(csr: CSRGraph, csc: CSRGraph,
                      device=None) -> LocalGraph:
    """Move a CSR/CSC pair to ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    n = csr.num_vertices
    arrays = local_graph_arrays(csr, csc)
    return LocalGraph(
        n=n, n_pad=bitmap.num_words(n) * bitmap.WORD_BITS,
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


def compact_indices(mask: torch.Tensor, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """P1 workload prep: indices of set bits, padded with -1 to ``cap``.

    A static-cap cumsum compaction (``torch.nonzero`` has a data-dependent
    shape and synchronises with the host).  Set bits beyond ``cap`` are
    dropped, like ``jnp.nonzero(size=cap)``.  Returns (int32[cap], count).
    """
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return out[:cap], mask.sum(dtype=torch.int32)


def expand_edges(active: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, budget: int):
    """P2 neighbor gather: flatten the neighbor lists of ``active`` vertices.

    Returns (sources, neighbors, valid, total_edges), the first two int32
    [budget] with -1 in invalid slots.  ``total_edges`` (a device scalar)
    may exceed ``budget``: the caller must treat that as overflow and
    retry with a bigger budget (the HBM-reader queue depth analogue).
    """
    dev = active.device
    a = active.clamp(min=0).to(torch.int64)
    deg = ((indptr[a + 1] - indptr[a]) * (active >= 0)).to(torch.int64)
    cum = torch.cumsum(deg, 0)
    total = cum[-1].to(torch.int32)
    e = torch.arange(budget, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(cum, e, right=True)
    owner_c = owner.clamp(max=active.shape[0] - 1)
    start = cum[owner_c] - deg[owner_c]
    src = active[owner_c]
    valid = e < cum[-1]
    if indices.shape[0] == 0:
        nbr = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    else:
        eidx = indptr[src.clamp(min=0).to(torch.int64)].to(torch.int64) \
            + (e - start)
        nbr = indices[torch.where(valid, eidx, 0)]
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    return (torch.where(valid, src, minus1),
            torch.where(valid, nbr, minus1), valid, total)


@runtime_checkable
class BFSEngine(Protocol):
    """Minimal contract the serving layer relies on: the number of
    vertices of the resident graph, its out-degrees (the TEPS numerator),
    and ``run_batch(roots)`` returning value rows [B, n] with per-run
    counters in ``last_stats``."""

    @property
    def num_vertices(self) -> int: ...

    @property
    def out_deg(self) -> "np.ndarray | None": ...

    def run_batch(self, roots) -> np.ndarray: ...


def validate_roots(roots: np.ndarray, num_vertices: int) -> np.ndarray:
    """Reject malformed MS-BFS root batches with a ``ValueError``.

    A negative or >= |V| root would index out of bounds (a wrapped row on
    the CPU, a device fault on CUDA).  Duplicate roots ARE allowed — each
    occupies its own bit-plane slot and resolves independently.
    """
    roots = np.asarray(roots)
    if roots.ndim != 1 or roots.size == 0:
        raise ValueError(
            f"roots must be a non-empty 1-D array, got shape {roots.shape}")
    if not np.issubdtype(roots.dtype, np.integer):
        raise ValueError(f"roots must be integers, got dtype {roots.dtype}")
    if ((roots < 0) | (roots >= num_vertices)).any():
        bad = roots[(roots < 0) | (roots >= num_vertices)]
        raise ValueError(
            f"roots out of range [0, {num_vertices}): {bad.tolist()[:8]}")
    return roots


def engine_num_vertices(engine) -> int | None:
    """|V| of the graph a BFS engine serves, or None (protocol first,
    then the ``.g`` duck-typing of older wrapper engines)."""
    n = getattr(engine, "num_vertices", None)
    if n is not None:
        return int(n)
    g = getattr(engine, "g", None)
    if g is not None:
        return int(g.n)
    return None


def count_traversed_edges(out_deg: np.ndarray, levels: np.ndarray) -> int:
    """Paper §VI-A GTEPS numerator: out-degrees of reached vertices, summed
    over every source row of ``levels`` ([n] or [B, n])."""
    levels = np.atleast_2d(np.asarray(levels))
    reached = levels < INF                            # [B, n]
    return int((reached @ np.asarray(out_deg, dtype=np.int64)).sum())


def bfs_oracle(csr: CSRGraph, root: int) -> np.ndarray:
    """Pure-python BFS (Algorithm 1) — the correctness oracle."""
    from collections import deque
    level = np.full(csr.num_vertices, INF, dtype=np.int64)
    level[root] = 0
    q = deque([root])
    while q:
        v = q.popleft()
        for u in csr.neighbors(v):
            if level[u] == INF:
                level[u] = level[v] + 1
                q.append(int(u))
    return level
