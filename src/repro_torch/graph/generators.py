"""Synthetic graph generators.

RMAT / Kronecker generator with Graph500 parameters (A=0.57, B=0.19,
C=0.19), matching the paper's synthetic workload suite ("RMAT<scale>-<deg>").
"""
from __future__ import annotations

import numpy as np


def rmat_edges(scale: int, edge_factor: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               permute: bool = True):
    """Graph500 Kronecker edge generator.

    Returns (src, dst) int64 arrays with ``edge_factor * 2**scale`` edges over
    ``2**scale`` vertices.  Vertex IDs are randomly permuted (Graph500 spec)
    so that degree is decorrelated from ID — this also exercises the paper's
    hash-partition load balancing.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    d = 1.0 - a - b - c
    ab = a + b
    p_dst1_given_src0 = b / ab          # quadrant B within row (A|B)
    p_dst1_given_src1 = d / (c + d)     # quadrant D within row (C|D)
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab               # P(src_bit=1) = c + d
        dst_bit = r2 < np.where(src_bit, p_dst1_given_src1, p_dst1_given_src0)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    if permute:
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    return src, dst


def uniform_edges(num_vertices: int, num_edges: int, seed: int = 0):
    """Erdos-Renyi-ish uniform random edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    return src, dst
