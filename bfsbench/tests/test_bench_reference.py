"""The plain reference BFS on hand-worked graphs, and its control."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bfsbench import kron, refbfs

INF = refbfs.INF


def csr_of(n, edges, undirected=True):
    src = torch.tensor([a for a, _ in edges], dtype=torch.int32)
    dst = torch.tensor([b for _, b in edges], dtype=torch.int32)
    if undirected:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    g = kron.build_csr(src, dst, n)
    return g.indptr, g.indices


@pytest.mark.parametrize("n, edges, root, want", [
    # a path 0-1-2-3-4
    (5, [(0, 1), (1, 2), (2, 3), (3, 4)], 2, [2, 1, 0, 1, 2]),
    # a star around 3, with 5 apart
    (6, [(3, 0), (3, 1), (3, 2), (3, 4)], 0, [0, 2, 2, 1, 2, INF]),
    # a cycle of 6: the far side at 3
    (6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)], 0,
     [0, 1, 2, 3, 2, 1]),
    # two components, a duplicate and a self-loop
    (7, [(0, 1), (1, 0), (1, 1), (1, 2), (4, 5), (5, 6)], 5,
     [INF, INF, INF, INF, 1, 0, 1]),
    # a chord shortens the way round
    (5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 3)], 0, [0, 1, 2, 1, 2]),
])
def test_hand_worked(n, edges, root, want):
    indptr, indices = csr_of(n, edges)
    got = refbfs.bfs_levels(indptr, indices, root)
    assert got.dtype == torch.int32
    assert got.tolist() == want


def test_directed_follows_arcs():
    indptr, indices = csr_of(4, [(0, 1), (1, 2), (3, 0)], undirected=False)
    assert refbfs.bfs_levels(indptr, indices, 0).tolist() == [0, 1, 2, INF]


def test_blocks_give_the_same_levels(monkeypatch):
    csr, _ = kron.build_graph({"scale": 10, "edge_factor": 8,
                               "initiator": [0.57, 0.19, 0.19, 0.05],
                               "undirected": True}, 3, torch.device("cpu"))
    whole = refbfs.bfs_levels(csr.indptr, csr.indices, 5)
    monkeypatch.setattr(refbfs, "_BLOCK_ARCS", 37)
    assert torch.equal(refbfs.bfs_levels(csr.indptr, csr.indices, 5), whole)


def test_mismatches_counts_vertices():
    indptr, indices = csr_of(5, [(0, 1), (1, 2), (2, 3), (3, 4)])
    row = np.array([0, 1, 2, 3, 4], dtype=np.int32)
    assert refbfs.mismatches(indptr, indices, 0, row) == 0
    row[3] = 7
    row[4] = INF
    assert refbfs.mismatches(indptr, indices, 0, row) == 2
    assert refbfs.mismatches(indptr, indices, 0, row[:3]) == 5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_comparison(seed):
    """The control (every level's expansion cut at a sixteenth of the
    arcs) departs from the reference on a Kronecker graph."""
    csr, _ = kron.build_graph({"scale": 11, "edge_factor": 16,
                               "initiator": [0.57, 0.19, 0.19, 0.05],
                               "undirected": True}, seed,
                              torch.device("cpu"))
    deg = csr.degrees()
    root = int(torch.argmax(deg))
    cap = refbfs.control_cap(csr.arcs)
    row = refbfs.bfs_levels(csr.indptr, csr.indices, root, cap).numpy()
    assert refbfs.mismatches(csr.indptr, csr.indices, root, row) > 0
