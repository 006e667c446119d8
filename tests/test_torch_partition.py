"""The port's hash partitioning (``repro_torch.core.partition``) against
the reference's (``repro.core.partition``): the same graphs give the same
arrays, and ``reindex`` / ``unreindex`` the same IDs."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import partition as jpart                  # noqa: E402
from repro.graph import get_dataset as j_get_dataset       # noqa: E402
from repro_torch.core import partition_graph               # noqa: E402
from repro_torch.core import partition as tpart            # noqa: E402
from repro_torch.graph import get_dataset                  # noqa: E402

FIELDS = ("num_vertices", "num_vertices_padded", "num_shards",
          "verts_per_shard", "scheme")
ARRAYS = ("out_indptr", "out_indices", "in_indptr", "in_indices")


@pytest.fixture
def graph_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("scheme", ["hash", "contiguous"])
@pytest.mark.parametrize("q", [1, 3, 4, 8])
@pytest.mark.parametrize("graph", ["tiny-16-4", "small-12-8"])
def test_partition_matches_reference(graph_cache, graph, q, scheme):
    ds, jds = get_dataset(graph), j_get_dataset(graph)
    got = partition_graph(ds.csr, ds.csc, q, scheme=scheme)
    want = jpart.partition_graph(jds.csr, jds.csc, q, scheme=scheme)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ARRAYS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.num_edges == want.num_edges == ds.csr.num_edges


@pytest.mark.parametrize("q", [1, 3, 4, 8])
def test_reindex_matches_reference(q):
    n = 1000
    vl = -(-n // q)
    v = np.arange(n, dtype=np.int64)
    r = tpart.reindex(v, q, vl)
    np.testing.assert_array_equal(r, jpart.reindex(v, q, vl))
    g = np.arange(q * vl, dtype=np.int64)
    np.testing.assert_array_equal(tpart.unreindex(g, q, vl),
                                  jpart.unreindex(g, q, vl))
    np.testing.assert_array_equal(tpart.unreindex(r, q, vl), v)


def test_partition_with_empty_shards_matches_reference():
    """More shards than vertices: some shards own nothing (hash) or the
    tail shards start past |V| (contiguous)."""
    from repro.graph import csr_from_edges as j_csr, transpose_csr as j_t
    from repro_torch.graph import csr_from_edges, transpose_csr
    src, dst = np.asarray([0, 1, 2, 4]), np.asarray([1, 2, 0, 0])
    csr, jcsr = csr_from_edges(src, dst, 5), j_csr(src, dst, 5)
    for scheme in ("hash", "contiguous"):
        got = partition_graph(csr, transpose_csr(csr), 8, scheme=scheme,
                              align=1, pad_multiple=4)
        want = jpart.partition_graph(jcsr, j_t(jcsr), 8, scheme=scheme,
                                     align=1, pad_multiple=4)
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_partition_preserves_edges(graph_cache):
    """The reference's property (tests/test_core_bfs.py): every edge lands
    in one shard, and every reindexed neighbour maps back to a vertex."""
    ds = get_dataset("small-12-8")
    pg = partition_graph(ds.csr, ds.csc, 4)
    assert pg.num_edges == ds.csr.num_edges
    ids = pg.out_indices[pg.out_indices >= 0]
    orig = tpart.unreindex(ids.astype(np.int64), pg.num_shards,
                           pg.verts_per_shard)
    assert (orig < ds.csr.num_vertices).all()
