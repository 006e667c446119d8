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
partitions rmat20-class graphs in seconds.  One rule, ``_shard_lists``
on tensors, builds every shard: :func:`partition_graph` runs it on the
host's arrays for all shards at once.

A rank that runs its own process needs only its own shards:
:class:`RankShards` holds one rank's ``k`` shards as tensors.
:meth:`PartitionedGraph.rank_shards` cuts them from the whole partition;
:func:`partition_rank_shards` builds each rank's directly from a CSR/CSC
held as tensors on the card, without the host arrays of all shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

    def rank_shards(self, rank: int, k: int) -> "RankShards":
        """Rank ``rank``'s ``k`` shards (shards ``rank*k`` to
        ``rank*k + k - 1``) as CPU tensors, offsets int32."""
        own = slice(rank * k, (rank + 1) * k)
        put = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x[own]))
        return RankShards(
            num_vertices=self.num_vertices,
            num_vertices_padded=self.num_vertices_padded,
            num_shards=self.num_shards, verts_per_shard=self.verts_per_shard,
            rank=rank, out_indptr=put(self.out_indptr.astype(np.int32)),
            out_indices=put(self.out_indices),
            in_indptr=put(self.in_indptr.astype(np.int32)),
            in_indices=put(self.in_indices), scheme=self.scheme)


@dataclasses.dataclass(frozen=True)
class RankShards:
    """One rank's ``k`` shards of a partition, as tensors on any device.

    out_indptr / in_indptr : int32[k, Vl+1]
    out_indices / in_indices: int32[k, E] (E the whole partition's padded
    width, -1 past each list).  ``rank`` is the rank's index over the
    engine's flattened mesh axes; ``out_deg``, original-order out-degrees
    int64[|V|], may ride along for the rank that serves the answers.
    """

    num_vertices: int
    num_vertices_padded: int
    num_shards: int
    verts_per_shard: int
    rank: int
    out_indptr: torch.Tensor
    out_indices: torch.Tensor
    in_indptr: torch.Tensor
    in_indices: torch.Tensor
    scheme: str = "hash"
    out_deg: np.ndarray | None = None

    @property
    def k(self) -> int:
        return int(self.out_indptr.shape[0])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.out_indptr, self.out_indices, self.in_indptr,
                self.in_indices)

    def to(self, device) -> "RankShards":
        """The same shards with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            name: t.to(device) for name, t in zip(
                ("out_indptr", "out_indices", "in_indptr", "in_indices"),
                self.tensors())})

    def share_memory_(self) -> "RankShards":
        """Move every (CPU) tensor into shared memory, in place: a spawned
        process then maps them instead of receiving a copy."""
        for t in self.tensors():
            t.share_memory_()
        return self


def reindex(v: np.ndarray, q: int, vl: int) -> np.ndarray:
    return (v % q) * vl + v // q


def unreindex(g: np.ndarray, q: int, vl: int) -> np.ndarray:
    return (g % vl) * q + g // vl


def _shard_lists(indptr: torch.Tensor, indices: torch.Tensor, n: int, q: int,
                 vl: int, pad_multiple: int, scheme: str,
                 shards) -> tuple[torch.Tensor, torch.Tensor]:
    """The shards ``shards`` of one side (CSR or CSC), on the tensors'
    device: their offsets int64[len(shards), vl + 1] and their reindexed
    neighbour lists int32[len(shards), E], -1 past each list, ``E`` the
    whole partition's longest shard rounded up to ``pad_multiple``.  Each
    shard's lists are gathered in one vectorised pass."""
    dev = indptr.device
    indptr = indptr.long()
    deg = indptr[1:] - indptr[:-1]
    if scheme == "hash":
        per = torch.zeros(q, dtype=torch.int64, device=dev).index_add_(
            0, torch.arange(n, device=dev) % q, deg)
    else:
        edge = torch.clamp(torch.arange(q + 1, device=dev) * vl, max=n)
        per = indptr[edge[1:]] - indptr[edge[:-1]]
    emax = int(per.max()) if q else 0
    emax = max(-(-emax // pad_multiple) * pad_multiple, pad_multiple)
    shards = list(shards)
    ptr = torch.zeros((len(shards), vl + 1), dtype=torch.int64, device=dev)
    body = torch.full((len(shards), emax), -1, dtype=torch.int32,
                      device=dev)
    for i, s in enumerate(shards):
        if scheme == "hash":                # paper: VID % Q == s
            owned = torch.arange(min(s, n), n, q, device=dev)
        else:                               # baseline: contiguous intervals
            owned = torch.arange(min(s * vl, n), min(s * vl + vl, n),
                                 device=dev)
        m = owned.numel()
        degs = deg[owned]
        torch.cumsum(degs, 0, out=ptr[i, 1: 1 + m])
        ptr[i, 1 + m:] = ptr[i, m]
        total = int(ptr[i, m])
        idx = torch.repeat_interleave(indptr[owned] - ptr[i, :m], degs,
                                      output_size=total)
        idx += torch.arange(total, device=dev)
        lst = indices[idx].long()
        del idx
        if scheme == "hash":
            lst = (lst % q) * vl + lst // q
        body[i, :total] = lst
    return ptr, body


def partition_graph(csr: CSRGraph, csc: CSRGraph, num_shards: int,
                    pad_multiple: int = 128, align: int = 32,
                    scheme: str = "hash") -> PartitionedGraph:
    n = csr.num_vertices
    q = num_shards
    vl = (n + q - 1) // q
    vl = ((vl + align - 1) // align) * align   # word-align shard ranges
    (out_indptr, out_indices), (in_indptr, in_indices) = (
        (x.numpy() for x in _shard_lists(
            torch.from_numpy(g.indptr), torch.from_numpy(g.indices), n, q,
            vl, pad_multiple, scheme, range(q)))
        for g in (csr, csc))
    return PartitionedGraph(
        num_vertices=n, num_vertices_padded=q * vl, num_shards=q,
        verts_per_shard=vl, out_indptr=out_indptr, out_indices=out_indices,
        in_indptr=in_indptr, in_indices=in_indices, scheme=scheme)


def partition_rank_shards(out_indptr: torch.Tensor, out_indices: torch.Tensor,
                          in_indptr: torch.Tensor, in_indices: torch.Tensor,
                          num_shards: int, ranks: int,
                          pad_multiple: int = 128, align: int = 32,
                          scheme: str = "hash") -> list[RankShards]:
    """Every rank's :class:`RankShards` of the CSR (``out_*``) / CSC
    (``in_*``) given as tensors (offsets int32 or int64, lists int32[E]),
    built on their device: equal to ``partition_graph(...).rank_shards(r,
    num_shards // ranks)`` of the same graph.  Rank 0's carries the
    original-order out-degrees."""
    if num_shards % ranks:
        raise ValueError(f"shards {num_shards} not a multiple of ranks "
                         f"{ranks}")
    n = int(out_indptr.shape[0]) - 1
    q, k = num_shards, num_shards // ranks
    vl = -(-n // q)
    vl = -(-vl // align) * align
    blocks = []
    for r in range(ranks):
        own = range(r * k, (r + 1) * k)
        sides = [_shard_lists(indptr, indices, n, q, vl, pad_multiple,
                              scheme, own)
                 for indptr, indices in ((out_indptr, out_indices),
                                         (in_indptr, in_indices))]
        blocks.append(RankShards(
            num_vertices=n, num_vertices_padded=q * vl, num_shards=q,
            verts_per_shard=vl, rank=r,
            out_indptr=sides[0][0].to(torch.int32), out_indices=sides[0][1],
            in_indptr=sides[1][0].to(torch.int32), in_indices=sides[1][1],
            scheme=scheme,
            out_deg=((out_indptr[1:] - out_indptr[:-1]).long().cpu().numpy()
                     if r == 0 else None)))
    return blocks
