"""The benchmark's graphs: Graph500 Kronecker edges generated on the device
from the seed, and the CSR/CSC built there.

This is part of the yardstick and imports nothing of the program.  The
generator follows the Graph500 specification's Kronecker initiator
(A, B, C, D) bit by bit, as ``repro_torch.graph.generators.rmat_edges``
does on the host: at every bit of the vertex id, the source bit is 1 with
probability C + D, and the target bit is 1 with probability B / (A + B)
when the source bit is 0, D / (C + D) when it is 1.  Vertex ids are then
permuted at random so that degree says nothing about the id.

The build sorts one combined key ``src * n + dst``, so arcs come out
ordered by (src, dst); it drops self-loops and merges duplicates.  An
undirected configuration gains each arc's reverse first, so its CSR is
its own transpose and serves as the CSC.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Rows of random numbers drawn in one call: bounds the generator's
# temporaries at a few GB while keeping the calls few and large.
_DRAW_CHUNK = 1 << 27


@dataclasses.dataclass(frozen=True)
class Csr:
    """One adjacency in CSR form on some device: ``indptr`` int64[n + 1],
    ``indices`` int32[arcs]."""

    n: int
    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def arcs(self) -> int:
        return int(self.indices.numel())

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def kronecker_edges(scale: int, edge_factor: int, initiator, seed: int,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """``edge_factor * 2**scale`` directed edges over ``2**scale`` vertices,
    int32 ids, drawn from ``seed`` by a ``torch.Generator`` on ``device``."""
    a, b, c, _d = (float(x) for x in initiator)
    n, m = 1 << scale, edge_factor << scale
    if scale > 30:
        raise ValueError(f"scale {scale} does not fit int32 vertex ids")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    p_dst_given_src0 = b / (a + b)
    p_dst_given_src1 = (1.0 - a - b - c) / (1.0 - a - b)
    for lo in range(0, m, _DRAW_CHUNK):
        hi = min(lo + _DRAW_CHUNK, m)
        s, t = src[lo:hi], dst[lo:hi]
        for bit in range(scale):
            r = torch.rand((2, hi - lo), generator=gen, device=device)
            s_bit = r[0] > (a + b)
            p = torch.where(s_bit, p_dst_given_src1, p_dst_given_src0)
            t_bit = r[1] < p
            s |= s_bit.to(torch.int32) << bit
            t |= t_bit.to(torch.int32) << bit
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    return perm[src.long()], perm[dst.long()]


def build_csr(src: torch.Tensor, dst: torch.Tensor, n: int) -> Csr:
    """CSR of the arcs ``src -> dst``: sorted by (src, dst), self-loops
    dropped, duplicates merged."""
    keep = src != dst
    key = src[keep].to(torch.int64) * n + dst[keep].to(torch.int64)
    key = torch.unique(key, sorted=True)
    s = torch.div(key, n, rounding_mode="floor")
    indices = (key - s * n).to(torch.int32)
    del key
    counts = torch.bincount(s, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Csr(n, indptr, indices)


def build_graph(cfg: dict, seed: int, device) -> tuple[Csr, Csr]:
    """(CSR, CSC) of the configuration's graph for ``seed`` on ``device``."""
    n = 1 << int(cfg["scale"])
    src, dst = kronecker_edges(int(cfg["scale"]), int(cfg["edge_factor"]),
                               cfg["initiator"], seed, device)
    if cfg["undirected"]:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        csr = build_csr(src, dst, n)
        return csr, csr
    csr = build_csr(src, dst, n)
    return csr, build_csr(dst, src, n)


def arc_sources(g: Csr) -> torch.Tensor:
    """The source vertex of every arc, int64[arcs]."""
    return torch.repeat_interleave(
        torch.arange(g.n, device=g.indptr.device), g.degrees(),
        output_size=g.arcs)


def component_arcs(g: Csr) -> torch.Tensor:
    """For every vertex of an undirected graph, the number of arcs in its
    connected component, int64[n].

    A BFS from a root reaches exactly the root's component, so this is the
    paper's traversed-edge count (§VI-A: the out-degrees of the vertices
    the query reached) of a correct answer from that root.  Labels are
    the least vertex id of each component, by min-label propagation with
    pointer jumping."""
    src = arc_sources(g)
    dst = g.indices.to(torch.int64)
    label = torch.arange(g.n, device=src.device)
    while True:
        new = label.clone()
        new.scatter_reduce_(0, dst, label[src], "amin")
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    per_label = torch.bincount(label[src], minlength=g.n)
    return per_label[label]


def to_host(g: Csr) -> tuple[np.ndarray, np.ndarray]:
    """``(indptr int64[n + 1], indices int32[arcs])`` as numpy arrays."""
    return g.indptr.cpu().numpy(), g.indices.cpu().numpy()
