"""The port's paged CSR gather (K5) and block-sparse pull SpMV (K6)
against the reference.

On the CPU the kernel wrappers run their plain versions, so these tests
hold the wrappers, the plain versions and the ``ops`` glue against the
reference's Pallas kernels in interpret mode and its oracles
(``repro.kernels.ref``): the gathered pages bit for bit, the page tables
array for array, the f32 SpMV accumulator bit for bit and the OR result
bool for bool.  ``tests/test_torch_cuda.py`` holds the CUDA kernels
against the plain versions on the card.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp                              # noqa: E402
import torch                                         # noqa: E402

from repro.kernels import ops as jops                # noqa: E402
from repro.kernels import ref as jref                # noqa: E402
from repro.kernels.csr_gather import gather_pages as j_gather_pages  # noqa: E402
from repro.kernels.pull_spmv import pull_spmv_blocks as j_pull_spmv_blocks  # noqa: E402
from repro_torch.interop import bf16_from_numpy      # noqa: E402
from repro_torch.kernels import ops, ref             # noqa: E402
from repro_torch.kernels.csr_gather import gather_pages  # noqa: E402
from repro_torch.kernels.pull_spmv import pull_spmv_blocks  # noqa: E402


def _i(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# ---------------------------------------------------------------------------
# K5: gather_pages, build_page_table, read_neighbor_pages
# ---------------------------------------------------------------------------

def _gather_case(num_pages, page, ids):
    rng = np.random.default_rng(num_pages + page + ids.size)
    edges = rng.integers(0, 10**6, (num_pages, page), dtype=np.int32)
    got = gather_pages(_i(edges), _i(ids)).numpy()
    want_ref = np.asarray(jref.gather_pages_ref(jnp.asarray(edges),
                                                jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want_ref)
    assert got.dtype == np.int32 and got.shape == (ids.size, page)
    return edges, got


@pytest.mark.parametrize("num_pages,page,m", [
    (8, 128, 4), (32, 256, 17), (64, 512, 64), (128, 128, 1),
])
def test_gather_pages_vs_pallas(num_pages, page, m):
    ids = np.random.default_rng(m).integers(0, num_pages, m).astype(np.int32)
    edges, got = _gather_case(num_pages, page, ids)
    want = j_gather_pages(jnp.asarray(edges), jnp.asarray(ids))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("page", [1, 3, 128])
def test_gather_pages_out_of_range_ids(page):
    """Ids past either end: wrapped once if negative, then clamped, as the
    reference's jnp indexing and its Pallas kernel give."""
    n = 5
    ids = np.asarray([0, n - 1, n, n + 3, 2 * n + 1, -1, -n, -n - 1,
                      -3 * n, 2], np.int32)
    edges, got = _gather_case(n, page, ids)
    want = j_gather_pages(jnp.asarray(edges), jnp.asarray(ids))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[[2, 3, 4]], edges[[n - 1] * 3])
    np.testing.assert_array_equal(got[[5, 6, 7, 8]], edges[[n - 1, 0, 0, 0]])


def test_gather_pages_empty_and_bad_shapes():
    edges = np.arange(12, dtype=np.int32).reshape(3, 4)
    got = gather_pages(_i(edges), _i(np.zeros(0)))
    assert got.shape == (0, 4) and got.dtype == torch.int32
    with pytest.raises(ValueError):
        gather_pages(_i(edges).reshape(-1), _i([0]))
    with pytest.raises(ValueError):
        gather_pages(_i(np.zeros((0, 4))), _i([0]))


def _degrees(seed, n, hi):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, hi, n)
    deg[rng.random(n) < 0.2] = 0                      # isolated vertices
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    return starts, deg


@pytest.mark.parametrize("page", [1, 7, 64, 128])
def test_build_page_table_equals_reference(page):
    starts, deg = _degrees(page, 60, 300)
    budget = int(sum(((s + d - 1) // page - s // page + 1)
                     for s, d in zip(starts, deg) if d > 0)) + 9
    got = ops.build_page_table(starts, deg, page, budget)
    want = jops.build_page_table(starts, deg, page, budget)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[1][-9:] == -1).all() and (got[0][-9:] == 0).all()


def test_build_page_table_edge_cases():
    # negative and zero degrees get no item; a list ending on a page edge
    starts = np.asarray([0, 64, 64, 70, 200])
    deg = np.asarray([64, 0, -3, 130, 1])
    for budget in (6, 8):
        for g, w in zip(ops.build_page_table(starts, deg, 64, budget),
                        jops.build_page_table(starts, deg, 64, budget)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(ops.build_page_table(starts[:0], deg[:0], 64, 0),
                    jops.build_page_table(starts[:0], deg[:0], 64, 0)):
        assert g.shape == w.shape == (0,) and g.dtype == w.dtype


def test_build_page_table_overflow():
    starts, deg = _degrees(5, 40, 200)
    need = int((jops.build_page_table(starts, deg, 64, 10**4)[1] >= 0).sum())
    with pytest.raises(OverflowError) as got:
        ops.build_page_table(starts, deg, 64, need - 1)
    with pytest.raises(OverflowError) as want:
        jops.build_page_table(starts, deg, 64, need - 1)
    assert str(got.value) == str(want.value)
    ops.build_page_table(starts, deg, 64, need)       # exactly fits


def test_page_table_covers_all_neighbor_lists():
    """The reassembly of tests/test_kernels.py, on the port, and the
    fetched pages equal the reference's."""
    rng = np.random.default_rng(7)
    page = 64
    degrees = rng.integers(0, 200, 50)
    starts = np.concatenate([[0], np.cumsum(degrees)[:-1]])
    total = int(degrees.sum())
    edges = rng.integers(0, 1000, ((total + page - 1) // page) * page,
                         dtype=np.int32)
    pids, owner, offs = ops.build_page_table(starts, degrees, page, 512)
    got = ops.read_neighbor_pages(_i(edges), _i(pids), page).numpy()
    want = jops.read_neighbor_pages(jnp.asarray(edges), jnp.asarray(pids),
                                    page)
    np.testing.assert_array_equal(got, np.asarray(want))
    for v in range(50):
        if degrees[v] == 0:
            continue
        parts, need = [], degrees[v]
        for i in np.flatnonzero(owner == v):
            lo = offs[i]
            take = min(need, page - lo)
            parts.append(got[i][lo: lo + take])
            need -= take
        np.testing.assert_array_equal(
            np.concatenate(parts), edges[starts[v]: starts[v] + degrees[v]])


# ---------------------------------------------------------------------------
# K6: pull_spmv_blocks, ops.pull_spmv
# ---------------------------------------------------------------------------

def _spmv_case(b, lanes, density, nb=12, rb=4, cb=4, seed=None,
               brow=None):
    rng = np.random.default_rng(b + lanes if seed is None else seed)
    tiles = (rng.random((nb, b, b)) < density).astype(np.float32)
    if brow is None:
        brow = np.sort(rng.integers(0, rb, nb))
    bcol = rng.integers(0, cb, nb)
    f = (rng.random((cb, b, lanes)) < 0.3).astype(np.float32)
    return tiles, np.asarray(brow, np.int32), bcol.astype(np.int32), f


def _both(tiles, brow, bcol, f, rb):
    """(port plain f32 accumulator, reference oracle's), both numpy."""
    got = pull_spmv_blocks(bf16_from_numpy(tiles, "cpu"), _i(brow), _i(bcol),
                           None, bf16_from_numpy(f, "cpu"), rb)
    want = jref.pull_spmv_blocks_ref(
        jnp.asarray(tiles).astype(jnp.bfloat16), jnp.asarray(brow),
        jnp.asarray(bcol), None, jnp.asarray(f).astype(jnp.bfloat16), rb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("b,lanes", [(128, 1), (128, 8), (128, 128),
                                     (256, 4)])
@pytest.mark.parametrize("density", [0.01, 0.2])
def test_pull_spmv_blocks_bit_exact(b, lanes, density):
    tiles, brow, bcol, f = _spmv_case(b, lanes, density)
    got, want = _both(tiles, brow, bcol, f, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pull_spmv_empty_row_blocks_are_zero():
    """Row blocks 0, 2 and 5 have no tile: 0 in the port and the oracle
    (the reference's TPU kernel leaves them unwritten)."""
    tiles, brow, bcol, f = _spmv_case(16, 4, 0.3, nb=5,
                                      brow=[1, 1, 3, 4, 4])
    got, want = _both(tiles, brow, bcol, f, 6)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[[0, 2, 5]].any() and got[[1, 3, 4]].any()


def test_pull_spmv_out_of_range_blocks():
    """block_col past either end is clamped, block_row past the end is
    dropped, negatives wrap once: the oracle's jnp indexing."""
    tiles, _, _, f = _spmv_case(16, 2, 0.5, nb=6, cb=3)
    brow = np.asarray([-1, 0, 3, -5, 1, 2], np.int32)
    bcol = np.asarray([-1, 5, 0, -4, 2, -3], np.int32)
    got, want = _both(tiles, brow, bcol, f, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("b,lanes", [(128, 1), (128, 8), (128, 128),
                                     (256, 4)])
@pytest.mark.parametrize("density", [0.01, 0.2])
def test_ops_pull_spmv_vs_reference(b, lanes, density):
    """ops.pull_spmv (no row_first: K6 needs none) against the
    reference's ops.pull_spmv, Pallas kernel in interpret mode."""
    tiles, brow, bcol, f = _spmv_case(b, lanes, density)
    got = ops.pull_spmv(bf16_from_numpy(tiles, "cpu"), _i(brow), _i(bcol),
                        bf16_from_numpy(f, "cpu"), 4)
    want = jops.pull_spmv(jnp.asarray(tiles).astype(jnp.bfloat16),
                          jnp.asarray(brow), jnp.asarray(bcol),
                          jnp.asarray(f).astype(jnp.bfloat16), 4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pull_spmv_kernel_matches_pallas_on_written_rows():
    """Where the reference's Pallas kernel writes a row block (one with a
    tile), its accumulator equals the port's bit for bit."""
    tiles, brow, bcol, f = _spmv_case(32, 8, 0.2, nb=7,
                                      brow=[0, 0, 0, 2, 2, 3, 3])
    row_first = np.asarray([1, 0, 0, 1, 0, 1, 0], np.int32)
    got = pull_spmv_blocks(bf16_from_numpy(tiles, "cpu"), _i(brow), _i(bcol),
                           _i(row_first), bf16_from_numpy(f, "cpu"), 4)
    want = np.asarray(j_pull_spmv_blocks(
        jnp.asarray(tiles).astype(jnp.bfloat16), jnp.asarray(brow),
        jnp.asarray(bcol), jnp.asarray(row_first),
        jnp.asarray(f).astype(jnp.bfloat16), num_row_blocks=4))
    written = [0, 2, 3]
    np.testing.assert_array_equal(got.numpy()[written], want[written])
    assert not got.numpy()[1].any()


def test_pull_spmv_is_boolean_semiring():
    """OR-AND semiring result == reachability through one block step."""
    rng = np.random.default_rng(3)
    b = 128
    a_np = rng.random((b, b)) < 0.05
    f_np = rng.random((b, 1)) < 0.5
    got = ops.pull_spmv(bf16_from_numpy(a_np[None].astype(np.float32), "cpu"),
                        _i([0]), _i([0]),
                        bf16_from_numpy(f_np[None].astype(np.float32), "cpu"),
                        1).numpy()[0, :, 0]
    np.testing.assert_array_equal(got, (a_np @ f_np.astype(np.int64))[:, 0] > 0)


def test_pull_spmv_checks_shapes():
    t = bf16_from_numpy(np.ones((2, 16, 16), np.float32), "cpu")
    f = bf16_from_numpy(np.ones((1, 16, 3), np.float32), "cpu")
    with pytest.raises(ValueError):
        pull_spmv_blocks(t[:, :, :8], _i([0, 0]), _i([0, 0]), None, f, 1)
    with pytest.raises(ValueError):
        pull_spmv_blocks(t, _i([0, 0]), _i([0, 0]), None, f[:, :8], 1)
    with pytest.raises(ValueError):
        pull_spmv_blocks(t, _i([0]), _i([0, 0]), None, f, 1)


# ---------------------------------------------------------------------------
# bf16 across the two packages
# ---------------------------------------------------------------------------

def test_bf16_interop_bits_equal_jax():
    """f32 -> bf16 rounds to nearest even in both packages: the same 16
    bits, ties included (1 + 2^-8 lies halfway between two bf16 values)."""
    ties = np.asarray([1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8),
                       2 + 2.0**-7, 3 * 2.0**-9 + 2.0**-1, 0.0, -0.0,
                       65504.0, 1e-40, np.inf, -np.inf], np.float32)
    rng = np.random.default_rng(0)
    vals = np.concatenate([ties, rng.standard_normal(4096).astype(np.float32)
                           * 10.0 ** rng.integers(-6, 6, 4096)])
    got = bf16_from_numpy(vals, "cpu")
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    assert got.dtype == torch.bfloat16 and got.shape == vals.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
