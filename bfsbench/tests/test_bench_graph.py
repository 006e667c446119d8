"""The device generator and CSR/CSC build, on the CPU."""
from __future__ import annotations

from collections import deque

import numpy as np
import pytest
import torch

from bfsbench import kron

CFG = {"scale": 10, "edge_factor": 8,
       "initiator": [0.57, 0.19, 0.19, 0.05], "undirected": True}
CPU = torch.device("cpu")


def numpy_csr(src, dst, n):
    """A plain numpy rebuild: drop self-loops, merge duplicates, sort by
    (src, dst)."""
    pairs = {(int(s), int(d)) for s, d in zip(src, dst) if s != d}
    pairs = np.array(sorted(pairs), dtype=np.int64).reshape(-1, 2)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, pairs[:, 0] + 1, 1)
    return np.cumsum(indptr), pairs[:, 1].astype(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_arcs_symmetric_sorted_simple(seed):
    csr, csc = kron.build_graph(CFG, seed, CPU)
    assert csc is csr
    indptr, indices = kron.to_host(csr)
    n = 1 << CFG["scale"]
    assert indptr[0] == 0 and indptr[-1] == indices.size
    src = np.repeat(np.arange(n), np.diff(indptr))
    assert not np.any(src == indices)                      # no self-loops
    key = src * n + indices
    assert np.all(np.diff(key) > 0)              # sorted, no duplicates
    assert set(key.tolist()) == set((indices.astype(np.int64) * n
                                     + src).tolist())        # symmetric


@pytest.mark.parametrize("undirected", [True, False])
def test_csr_build_equals_numpy_rebuild(undirected):
    n = 1 << CFG["scale"]
    src, dst = kron.kronecker_edges(CFG["scale"], CFG["edge_factor"],
                                    CFG["initiator"], 3, CPU)
    assert src.numel() == CFG["edge_factor"] * n
    assert int(src.min()) >= 0 and int(src.max()) < n
    csr, csc = kron.build_graph(dict(CFG, undirected=undirected), 3, CPU)
    s, d = src.numpy(), dst.numpy()
    if undirected:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    want = numpy_csr(s, d, n)
    got = kron.to_host(csr)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    want_t = numpy_csr(d, s, n)
    got_t = kron.to_host(csc)
    np.testing.assert_array_equal(got_t[0], want_t[0])
    np.testing.assert_array_equal(got_t[1], want_t[1])


def test_same_seed_same_graph():
    a = kron.to_host(kron.build_graph(CFG, 11, CPU)[0])
    b = kron.to_host(kron.build_graph(CFG, 11, CPU)[0])
    c = kron.to_host(kron.build_graph(CFG, 12, CPU)[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].size != c[1].size or not np.array_equal(a[1], c[1])


def test_kronecker_matches_graph500_generator():
    """The same distribution as the host generator the program's datasets
    use (``repro_torch.graph``): arcs after dedup within 1%, and the top
    of the degree sequence within 15%, at scale 14."""
    from repro_torch.graph.csr import csr_from_edges, symmetrize_edges
    from repro_torch.graph.generators import rmat_edges
    cfg = dict(CFG, scale=14, edge_factor=16)
    n = 1 << cfg["scale"]
    ours = kron.to_host(kron.build_graph(cfg, 9, CPU)[0])
    s, d = symmetrize_edges(*rmat_edges(cfg["scale"], cfg["edge_factor"],
                                        seed=9))
    theirs = csr_from_edges(s, d, n)
    assert ours[1].size == pytest.approx(theirs.indices.size, rel=0.01)
    top_ours = np.sort(np.diff(ours[0]))[-64:].astype(float)
    top_theirs = np.sort(np.diff(theirs.indptr))[-64:].astype(float)
    assert top_ours.sum() == pytest.approx(top_theirs.sum(), rel=0.15)


def test_component_arcs_match_bfs():
    csr, _ = kron.build_graph(CFG, 4, CPU)
    indptr, indices = kron.to_host(csr)
    got = kron.component_arcs(csr).numpy()
    deg = np.diff(indptr)
    n = indptr.size - 1
    comp = np.full(n, -1)
    for v in range(n):
        if comp[v] >= 0:
            continue
        comp[v] = v
        q = deque([v])
        while q:
            u = q.popleft()
            for w in indices[indptr[u]:indptr[u + 1]]:
                if comp[w] < 0:
                    comp[w] = v
                    q.append(w)
    want = np.zeros(n, dtype=np.int64)
    for v in range(n):
        want[v] = deg[comp == comp[v]].sum()
    np.testing.assert_array_equal(got, want)
