"""CSR/CSC graph representation (paper §II-C), host-side numpy.

A copy of ``repro.graph.csr`` (which the port may not import).  The arrays
it builds are equal to the reference's; the sort by ``(src, dst)`` is one
``np.sort`` over a combined int64 key instead of a two-key ``lexsort``,
which gives the same arrays and builds rmat20-class graphs several times
faster.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row adjacency.

    indptr:  int64[num_vertices + 1] — offset array (paper's "offset array").
    indices: int32[num_edges]        — concatenated neighbor lists ("edge array").
    """

    num_vertices: int
    indptr: np.ndarray
    indices: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]


def csr_from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   dedup: bool = True, drop_self_loops: bool = True) -> CSRGraph:
    """Build CSR from an edge list (src -> dst)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    # one combined key sorts by (src, dst); dedup keeps one copy per key
    key = src * num_vertices + dst
    key = np.unique(key) if (dedup and key.size) else np.sort(key)
    src, dst = np.divmod(key, num_vertices)
    counts = np.bincount(src, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(num_vertices=num_vertices, indptr=indptr,
                    indices=dst.astype(np.int32))


def transpose_csr(g: CSRGraph) -> CSRGraph:
    """CSC of g == CSR of the reversed edge list."""
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int64), g.degrees())
    dst = g.indices.astype(np.int64)
    return csr_from_edges(dst, src, g.num_vertices, dedup=False,
                          drop_self_loops=False)


def symmetrize_edges(src: np.ndarray, dst: np.ndarray):
    """Undirected -> directed: each edge becomes two opposite arcs (paper §VI-A)."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def symmetrize_csr(g: CSRGraph) -> CSRGraph:
    """Undirected view of a (possibly directed) CSR: every arc gains its
    reverse, duplicates collapse, self-loops drop (``csr_from_edges``
    defaults).  The result is its own transpose, which is what the
    connected-components engine builds on."""
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int64), g.degrees())
    dst = g.indices.astype(np.int64)
    s, d = symmetrize_edges(src, dst)
    return csr_from_edges(s, d, g.num_vertices)


def edge_sources(g: CSRGraph) -> np.ndarray:
    """Per-edge source vertex (src_of_edge[e])."""
    return np.repeat(np.arange(g.num_vertices, dtype=np.int32),
                     g.degrees()).astype(np.int32)
