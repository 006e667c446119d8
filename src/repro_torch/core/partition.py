"""Horizontal hash partitioning of the vertex space (paper §IV-A/B); a
copy of ``repro.core.partition`` (which the port may not import).

ScalaBFS assigns vertex ``v`` to PE ``v % Q`` (interval hashing for load
balance) and keeps whole neighbor lists inside the owning partition
("horizontal" split of the adjacency matrix — lists are never broken, which
preserves long sequential reads from the memory channel).

Vertices are re-indexed so that partition ``s`` owns the *contiguous*
reindexed range ``[s*Vl, (s+1)*Vl)``:

    reindex(v) = (v % Q) * Vl + v // Q           (Vl = ceil(|V|/Q))

The contiguous layout makes shard boundaries coincide with bitmap word
boundaries and with the rank blocks of the device mesh, while preserving
the paper's exact modulo load-balancing.  All BFS-internal IDs are
reindexed; results are mapped back at the end.

The arrays equal the reference's; each shard's neighbour lists are
gathered in one vectorised pass instead of one slice per vertex, which
partitions rmat20-class graphs in seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-shard CSR+CSC in reindexed vertex space, padded & stacked.

    All arrays have a leading shard axis Q, split across the mesh's ranks.

    out_indptr : int64[Q, Vl+1]  — CSR offsets of *owned* vertices (local rows)
    out_indices: int32[Q, Eout]  — global reindexed child IDs (padded with -1)
    in_indptr  : int64[Q, Vl+1]  — CSC offsets of owned vertices
    in_indices : int32[Q, Ein]   — global reindexed parent IDs (padded with -1)
    """

    num_vertices: int            # original |V|
    num_vertices_padded: int     # Q * Vl
    num_shards: int
    verts_per_shard: int
    out_indptr: np.ndarray
    out_indices: np.ndarray
    in_indptr: np.ndarray
    in_indices: np.ndarray
    scheme: str = "hash"         # "hash" (paper) | "contiguous" (baseline)

    @property
    def num_edges(self) -> int:
        return int((self.out_indices >= 0).sum())


def reindex(v: np.ndarray, q: int, vl: int) -> np.ndarray:
    return (v % q) * vl + v // q


def unreindex(g: np.ndarray, q: int, vl: int) -> np.ndarray:
    return (g % vl) * q + g // vl


def _owned(s: int, n: int, q: int, vl: int, scheme: str) -> np.ndarray:
    if scheme == "hash":
        return np.arange(s, n, q)           # paper: VID % Q == s
    lo = min(s * vl, n)                     # baseline: contiguous intervals
    return np.arange(lo, min(lo + vl, n))


def _gather_lists(indptr: np.ndarray, indices: np.ndarray,
                  owned: np.ndarray, degs: np.ndarray) -> np.ndarray:
    """The neighbour lists of ``owned`` concatenated in order."""
    total = int(degs.sum())
    if total == 0:
        return np.zeros(0, np.int32)
    first = np.cumsum(degs) - degs
    idx = np.repeat(indptr[owned] - first, degs) + np.arange(total)
    return indices[idx]


def _shard_lists(indptr: np.ndarray, indices: np.ndarray, n: int, q: int,
                 vl: int, pad_multiple: int,
                 scheme: str = "hash") -> tuple[np.ndarray, np.ndarray]:
    """Slice the neighbor-list arrays of each shard's owned vertices."""
    shard_indptr = np.zeros((q, vl + 1), dtype=np.int64)
    shard_lists = []
    all_degs = np.diff(indptr)
    for s in range(q):
        owned = _owned(s, n, q, vl, scheme)
        degs = all_degs[owned] if owned.size else np.zeros(0, np.int64)
        ptr = np.zeros(vl + 1, dtype=np.int64)
        np.cumsum(degs, out=ptr[1: 1 + owned.size])
        if owned.size < vl:
            ptr[1 + owned.size:] = ptr[owned.size]
        shard_indptr[s] = ptr
        shard_lists.append(_gather_lists(indptr, indices, owned, degs))
    emax = max((x.size for x in shard_lists), default=0)
    emax = ((emax + pad_multiple - 1) // pad_multiple) * pad_multiple
    emax = max(emax, pad_multiple)
    out = np.full((q, emax), -1, dtype=np.int32)
    for s, lst in enumerate(shard_lists):
        lst64 = lst.astype(np.int64)
        out[s, : lst.size] = (reindex(lst64, q, vl) if scheme == "hash"
                              else lst64)
    return shard_indptr, out


def partition_graph(csr: CSRGraph, csc: CSRGraph, num_shards: int,
                    pad_multiple: int = 128, align: int = 32,
                    scheme: str = "hash") -> PartitionedGraph:
    n = csr.num_vertices
    q = num_shards
    vl = (n + q - 1) // q
    vl = ((vl + align - 1) // align) * align   # word-align shard ranges
    out_indptr, out_indices = _shard_lists(csr.indptr, csr.indices, n, q, vl,
                                           pad_multiple, scheme)
    in_indptr, in_indices = _shard_lists(csc.indptr, csc.indices, n, q, vl,
                                         pad_multiple, scheme)
    return PartitionedGraph(
        num_vertices=n, num_vertices_padded=q * vl, num_shards=q,
        verts_per_shard=vl, out_indptr=out_indptr, out_indices=out_indices,
        in_indptr=in_indptr, in_indices=in_indices, scheme=scheme)
