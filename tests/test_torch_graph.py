"""The port's graph layer (``repro_torch.graph``) against the reference's
(``repro.graph``): same generator output, same CSR/CSC arrays."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.graph import csr as jcsr                      # noqa: E402
from repro.graph import get_dataset as j_get_dataset     # noqa: E402
from repro.graph import rmat_edges as j_rmat_edges       # noqa: E402
from repro_torch.graph import csr as tcsr                # noqa: E402
from repro_torch.graph import datasets as tdatasets      # noqa: E402
from repro_torch.graph import get_dataset, rmat_edges    # noqa: E402


def _same_csr(a, b):
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("name", ["tiny-16-4", "small-12-8"])
def test_get_dataset_equal(name, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    want = j_get_dataset(name)
    got = get_dataset(name)
    _same_csr(got.csr, want.csr)
    _same_csr(got.csc, want.csc)
    # the cached copy reloads to the same arrays
    again = get_dataset(name)
    _same_csr(again.csr, want.csr)
    assert list(tmp_path.iterdir())
    assert str(tmp_path) == tdatasets.cache_dir()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_rmat_edges_equal(seed):
    ws, wd = j_rmat_edges(8, 4, seed=seed)
    gs, gd = rmat_edges(8, 4, seed=seed)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("dedup,loops", [(True, True), (False, False),
                                         (True, False)])
def test_csr_from_edges_equal(dedup, loops):
    """The port sorts by one combined key instead of lexsort: the arrays
    must not change, duplicates and self-loops included."""
    rng = np.random.default_rng(3)
    n = 50
    src = rng.integers(0, n, 600)
    dst = rng.integers(0, n, 600)
    src[:40] = dst[:40]                       # self-loops
    src[40:80], dst[40:80] = src[80:120], dst[80:120]   # duplicates
    want = jcsr.csr_from_edges(src, dst, n, dedup=dedup,
                               drop_self_loops=loops)
    got = tcsr.csr_from_edges(src, dst, n, dedup=dedup,
                              drop_self_loops=loops)
    _same_csr(got, want)
    _same_csr(tcsr.transpose_csr(got), jcsr.transpose_csr(want))
    np.testing.assert_array_equal(tcsr.edge_sources(got),
                                  jcsr.edge_sources(want))
