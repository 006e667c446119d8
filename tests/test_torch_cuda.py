"""The CUDA kernels on the card against their plain versions: bit for bit,
except flash attention (K7), held within a stated tolerance.  The LM
stack (no kernel of its own) on the card against the CPU port on the same
weights: bf16 within an rms ratio of 2e-2, a float32 MoE layer with
identical routing.

Marked ``cuda``: each test skips with a reason where there is no CUDA
device (the kernels have no CPU mode).  This file imports neither JAX nor
the reference package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (BFSRunner, MultiSourceBFSRunner,
                              SSSPRunner, build_local_graph)
from repro_torch.graph import csr_from_edges, transpose_csr
from repro_torch.interop import bf16_from_numpy, planes_from_numpy
from repro_torch.kernels import bitmap_update as kbu
from repro_torch.kernels import csr_gather as kcg
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import msbfs_propagate as kmod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pull_spmv as kps

TILE, BLOCK = 16, 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def _i(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("n_rows,nw,m", [(33, 1, 64), (65, 2, 128),
                                         (17, 3, 96)])
def test_whole_array_kernel(dev, n_rows, nw, m, op):
    f, s = _words((n_rows, nw), m), _words((n_rows, nw), m + 1)
    f[-1], s[-1] = 0, 0xFFFFFFFF                 # trash-row contract
    rng = np.random.default_rng(nw)
    args = (planes_from_numpy(f, dev), planes_from_numpy(s, dev),
            _i(rng.integers(0, n_rows, m), dev),
            _i(rng.integers(0, n_rows, m), dev))
    _same(kmod.msbfs_propagate_planes(*args, op=op),
          ref.msbfs_propagate_planes_ref(*args, op=op))
    torch.cuda.synchronize()


K1_CASES = ("valid holes", "n_edges 0", "n_edges inside", "n_edges = m",
            "n_edges beyond m", "out of range", "fewer slots than threads")


def _k1_case(name, nw, seed, dev):
    """(frontier, seen, src, tgt, valid, n_edges) on the card, n = 41."""
    rng = np.random.default_rng(seed)
    n, m = 41, 300
    if name == "fewer slots than threads":
        m = 5
    f = _words((n, nw), seed)
    f[rng.random(n) < 0.3] = 0
    s = _words((n, nw), seed + 1)
    src = rng.integers(0, n, m)
    tgt = rng.integers(0, n, m)
    tgt[:40] = tgt[0]                         # colliding targets
    valid = np.ones(m, bool)
    n_edges = m
    if name == "valid holes":
        valid = rng.random(m) < 0.6
    elif name == "n_edges 0":
        n_edges = 0
    elif name == "n_edges inside":
        n_edges = 137
    elif name == "n_edges beyond m":
        n_edges = m + 50
    elif name == "out of range":
        src[::7] = rng.integers(-3, 0, src[::7].size)
        tgt[3::11] = n + rng.integers(0, 3, tgt[3::11].size)
        tgt[5::13] = -1
        valid = rng.random(m) < 0.9
        n_edges = 251
    return (planes_from_numpy(f, dev), planes_from_numpy(s, dev),
            _i(src, dev), _i(tgt, dev), torch.from_numpy(valid).to(dev),
            torch.tensor(n_edges, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("nw", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", K1_CASES)
def test_whole_array_kernel_new_form(dev, case, nw, op):
    """K1 on the edge list as it stands (valid, n_edges on the card)
    against its plain version, through the wrapper, through its C launch
    function's three launches one at a time, and through
    ``ops.msbfs_propagate(tile_rows=0)``.  The grid always has far more
    threads than slots."""
    f, s, src, tgt, valid, ne = _k1_case(case, nw, nw * 31 + len(case), dev)
    want = ref.msbfs_propagate_planes_ref(f, s, src, tgt, op, valid, ne)
    kmod.reset_launches()
    _same(kmod.msbfs_propagate_planes(f, s, src, tgt, op, valid, ne), want)
    assert kmod.LAUNCHES["msbfs_propagate_planes"] == 1
    got = ops.msbfs_propagate(f, s, src, tgt, valid, op=op, tile_rows=0,
                              n_edges=ne)
    _same(got, (want[0], want[1], want[2][0, 0]))
    new, seen_out = torch.empty_like(f), torch.empty_like(s)
    cnt = torch.empty((1, 1), dtype=torch.int32, device=dev)
    args = kmod.whole_launch_args(f, s, src, tgt, valid, ne, new, seen_out,
                                  cnt, op)
    lib = kmod._lib()
    new.fill_(-1)
    cnt.fill_(-1)
    for phases in (0x1, 0x2, 0x4):
        assert lib.msbfs_propagate_planes_launch(
            *args, phases, torch.cuda.current_stream(dev).cuda_stream) == 0
    _same((new, seen_out, cnt), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_whole_array_kernel_reads_no_slot_past_n_edges(dev):
    """Slots at and after n_edges hold valid in-range edges whose messages
    are not zero; none of them may reach the outputs."""
    f, s, src, tgt, valid, _ = _k1_case("valid holes", 2, 5, dev)
    f[3] = -1
    src[200:] = 3
    tgt[200:] = torch.arange(100, device=dev, dtype=torch.int32) % 41
    valid[200:] = True
    want = ref.msbfs_propagate_planes_ref(f, s, src[:200], tgt[:200], "or",
                                          valid[:200])
    assert not torch.equal(want[0], ref.msbfs_propagate_planes_ref(
        f, s, src, tgt, "or", valid)[0])
    ne = torch.tensor(200, dtype=torch.int32, device=dev)
    _same(kmod.msbfs_propagate_planes(f, s, src, tgt, "or", valid, ne), want)
    _same(kmod.msbfs_propagate_planes(f, s, src, tgt, "or", valid, 200), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_whole_array_kernel_refuses_bad_arguments(dev):
    f, s, src, tgt, valid, ne = _k1_case("valid holes", 2, 9, dev)
    with pytest.raises(ValueError):
        kmod.msbfs_propagate_planes(f, s, src, tgt, "or", valid[:-1], ne)
    with pytest.raises(ValueError):
        kmod.msbfs_propagate_planes(f, s, src, tgt, "or", valid,
                                    ne.to(torch.int64))
    with pytest.raises(TypeError):
        kmod.msbfs_propagate_planes(f, s, src, tgt, "or", valid.to(
            torch.int32), ne)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("n", [TILE + 1, 5 * TILE])
def test_tiled_kernel_and_both_plans(dev, n, op):
    rng = np.random.default_rng(n)
    frontier = planes_from_numpy(_words((n, 2), n), dev)
    seen = planes_from_numpy(_words((n, 2), n + 1), dev)
    src = _i(rng.integers(-2, n + 3, 300), dev)
    tgt = _i(rng.integers(-2, n + 3, 300), dev)
    valid = torch.from_numpy(rng.random(300) < 0.9).to(dev)
    ok = ops._edge_ok(valid, src, tgt, n)
    *k2, heads = ops._tiled_inputs(seen, frontier, src, tgt, ok, TILE, BLOCK)
    _same(kmod.msbfs_propagate_planes_tiled(*k2, heads, TILE, BLOCK, op=op),
          ref.msbfs_propagate_planes_tiled_ref(*k2, TILE, BLOCK, op=op))
    whole = ops.msbfs_propagate(frontier, seen, src, tgt, valid,
                                block_edges=BLOCK, op=op, tile_rows=0)
    tiled = ops.msbfs_propagate(frontier, seen, src, tgt, valid,
                                block_edges=BLOCK, op=op, tile_rows=TILE)
    _same(whole, tiled)
    torch.cuda.synchronize()


def _k2_holds(dev, frontier, seen, src, tgt, valid, tile_rows, block,
              msg_offset=0):
    """K2 bit-exact against its plain version, both ops, on the bucketed
    stream of these edges, given its run heads.  ``msg_offset``
    words shift the message stream off its allocation's alignment."""
    n, nw = frontier.shape
    args = [planes_from_numpy(frontier, dev), planes_from_numpy(seen, dev),
            _i(src, dev), _i(tgt, dev),
            torch.from_numpy(np.asarray(valid, bool)).to(dev)]
    ok = ops._edge_ok(args[4], args[2], args[3], n)
    s, sm, st, ct, heads = ops._tiled_inputs(args[1], args[0], args[2],
                                             args[3], ok, tile_rows, block)
    if msg_offset:
        buf = torch.empty(sm.numel() + msg_offset, dtype=torch.int32,
                          device=dev)
        buf[msg_offset:] = sm.reshape(-1)
        sm = buf[msg_offset:].view(sm.shape)
    for op in ("or", "max"):
        want = ref.msbfs_propagate_planes_tiled_ref(s, sm, st, ct, tile_rows,
                                                    block, op=op)
        _same(kmod.msbfs_propagate_planes_tiled(s, sm, st, ct, heads,
                                                tile_rows, block, op=op),
              want)
    torch.cuda.synchronize()
    return heads, ct


def _edges(n, nw, m, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    return (_words((n, nw), seed), _words((n, nw), seed + 1),
            rng.integers(0, n, m), rng.integers(lo, n if hi is None else hi,
                                                m))


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 2, 3, 8])
def test_tiled_kernel_word_widths(dev, nw):
    """nw 1 and 2 (one vector load an edge), 3 (scalar), 8 (uint4
    groups), with invalid and out-of-range slots."""
    n, m = 40 * TILE + 5, 5000
    f, s, src, tgt = _edges(n, nw, m, nw)
    tgt[::7] = -1
    valid = np.random.default_rng(nw).random(m) < 0.8
    _k2_holds(dev, f, s, src, tgt, valid, TILE, BLOCK)


@pytest.mark.cuda
def test_tiled_kernel_misaligned_stream(dev):
    """A message stream 4 bytes off its alignment takes the scalar loads."""
    f, s, src, tgt = _edges(20 * TILE, 4, 3000, 5)
    _k2_holds(dev, f, s, src, tgt, np.ones(3000, bool), TILE, BLOCK,
              msg_offset=1)


@pytest.mark.cuda
def test_tiled_kernel_hub_tile_spans_blocks(dev):
    """One tile takes 300,000 of 310,000 edges: its run spans hundreds of
    the persistent grid's slices, so its parts meet in L2 and the last
    one applies P3."""
    n, nw, m = 64 * TILE, 2, 310_000
    f, s, src, tgt = _edges(n, nw, m, 11)
    tgt[:300_000] = 5 * TILE + np.arange(300_000) % TILE
    heads, _ = _k2_holds(dev, f, s, src, tgt, np.ones(m, bool), TILE, 1024)
    assert int(heads[5]) * 1024 >= 300_000


@pytest.mark.cuda
def test_tiled_kernel_every_tile_empty(dev):
    """No valid edge: every tile's run is empty and only P3 on empty
    candidates runs (new 0, seen copied, count 0)."""
    f, s, src, tgt = _edges(30 * TILE, 2, 4000, 13)
    heads, _ = _k2_holds(dev, f, s, src, tgt, np.zeros(4000, bool), TILE,
                         BLOCK)
    assert not heads.any()


@pytest.mark.cuda
def test_tiled_kernel_one_tile_holds_every_edge(dev):
    f, s, src, tgt = _edges(30 * TILE, 2, 20_000, 17, lo=TILE,
                            hi=2 * TILE)
    heads, _ = _k2_holds(dev, f, s, src, tgt, np.ones(20_000, bool), TILE,
                         BLOCK)
    assert int((heads > 0).sum()) == 1


@pytest.mark.cuda
def test_tiled_kernel_trailing_pad_chunks(dev):
    """A budget of 330,000 slots with 300 valid edges: over 10,000
    trailing pad chunks ride the last tile; K2 reads none of them."""
    n, m = 12 * TILE, 330_000
    f, s, src, tgt = _edges(n, 2, m, 19)
    valid = np.zeros(m, bool)
    valid[np.random.default_rng(20).choice(m, 300, replace=False)] = True
    tgt[np.flatnonzero(valid)[:20]] = n - 1
    heads, ct = _k2_holds(dev, f, s, src, tgt, valid, TILE, BLOCK)
    assert ct.shape[0] - int(heads.sum()) > 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [None, 0, TILE])
def test_engine_on_card_equals_cpu_plain_path(dev, tile_rows):
    rng = np.random.default_rng(1)
    n = 256
    src, dst = rng.integers(0, 192, 1500), rng.integers(0, 192, 1500)
    csr = csr_from_edges(src, dst, n)
    roots = np.asarray([0, 5, 5, 191, 255] + list(range(20, 60)))
    want = MultiSourceBFSRunner(build_local_graph(csr, transpose_csr(csr),
                                                  device="cpu"),
                                use_kernels=False).run(roots)
    kmod.reset_launches()
    got = MultiSourceBFSRunner(build_local_graph(csr, transpose_csr(csr),
                                                 device=dev),
                               tile_rows=tile_rows).run(roots)
    np.testing.assert_array_equal(got.levels, want.levels)
    assert got.iterations == want.iterations
    assert got.host_transfers == got.iterations + 2
    assert sum(kmod.LAUNCHES.values()) >= got.iterations
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(build_local_graph(csr, transpose_csr(csr),
                                               device=dev), use_kernels=False)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 31, 127, 129, 257, 8191, 32768])
def test_bitmap_update_kernel(dev, w):
    """K4 on odd, prime and real (rmat20: 32,768) word counts, random
    words (bit 31 set in about half), all-ones and misaligned views."""
    c, v = _words((w,), w), _words((w,), w + 1)
    c[: min(w, 7)] = 0xFFFFFFFF
    args = (planes_from_numpy(c, dev), planes_from_numpy(v, dev))
    kbu.reset_launches()
    _same(kbu.bitmap_update(*args), ref.bitmap_update_ref(*args))
    assert kbu.LAUNCHES["bitmap_update"] == 1
    if w > 1:                       # a view 4 bytes past a 16-byte boundary
        cut = (args[0][1:].contiguous(), args[1][1:].contiguous())
        _same(kbu.bitmap_update(args[0][1:], args[1][1:]),
              ref.bitmap_update_ref(*cut))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 129, 32768, 1 << 21])
def test_bitmap_update_kernel_out_buffers(dev, w):
    """K4 into out= buffers, three calls in a row on changing inputs (the
    kernel resets its arrival counter), at one block and at many."""
    o = (torch.empty(w, dtype=torch.int32, device=dev),
         torch.empty(w, dtype=torch.int32, device=dev),
         torch.empty((1, 1), dtype=torch.int32, device=dev))
    for k in range(3):
        c = planes_from_numpy(_words((w,), w + k), dev)
        v = planes_from_numpy(_words((w,), w + k + 7), dev)
        o[2].fill_(-1)
        got = kbu.bitmap_update(c, v, out=o)
        assert all(a is b for a, b in zip(got, o))
        _same(got, ref.bitmap_update_ref(c, v))
    assert int(kbu.scratch_for(dev)[0]) == 0
    with pytest.raises(ValueError):
        kbu.bitmap_update(c, v, out=(c, o[1], o[2]))
    with pytest.raises(ValueError):
        kbu.bitmap_update(c, v, out=(o[0], o[0], o[2]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("g,w", [(1, 1), (2, 31), (3, 127), (2, 129),
                                 (3, 1009), (2, 4096)])
def test_bitmap_update_batch_kernel(dev, g, w):
    c, v = _words((g, w), g * w), _words((g, w), g * w + 1)
    c[0] = 0xFFFFFFFF
    v[-1] = 0
    args = (planes_from_numpy(c, dev), planes_from_numpy(v, dev))
    kbu.reset_launches()
    _same(kbu.bitmap_update_batch(*args), ref.bitmap_update_batch_ref(*args))
    assert kbu.LAUNCHES["bitmap_update_batch"] == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_p3_kernels_refuse_what_they_cannot_take(dev):
    c = planes_from_numpy(_words((4, 8), 1), dev)
    with pytest.raises(ValueError):
        kbu.bitmap_update(c, c)                   # K4 takes flat words
    with pytest.raises(ValueError):
        kbu.bitmap_update_batch(c.T, c.T)          # not contiguous
    with pytest.raises(TypeError):
        kbu.bitmap_update(c.reshape(-1).to(torch.int64),
                          c.reshape(-1).to(torch.int64))


def _card_and_cpu_graphs(dev):
    rng = np.random.default_rng(2)
    n = 256
    src, dst = rng.integers(0, 192, 1500), rng.integers(0, 192, 1500)
    csr = csr_from_edges(src, dst, n)
    return (build_local_graph(csr, transpose_csr(csr), device="cpu"),
            build_local_graph(csr, transpose_csr(csr), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["push", "pull", "beamer"])
def test_single_source_runner_on_card_equals_cpu_plain_path(dev, policy):
    from repro_torch.core import SchedulerConfig
    cpu, card = _card_and_cpu_graphs(dev)
    for root in (0, 5, 191, 255):
        want = BFSRunner(cpu, SchedulerConfig(policy=policy),
                         use_kernels=False).run(root)
        kbu.reset_launches()
        got = BFSRunner(card, SchedulerConfig(policy=policy)).run(root)
        np.testing.assert_array_equal(got.level, want.level)
        for k in ("iterations", "edges_inspected", "push_iters",
                  "pull_iters", "host_transfers"):
            assert getattr(got, k) == getattr(want, k), k
        assert kbu.LAUNCHES["bitmap_update"] == got.iterations + \
            got.overflow_retries
    with pytest.raises(ValueError):
        BFSRunner(card, use_kernels=False)


@pytest.mark.cuda
def test_boolplane_and_sssp_on_card_equal_cpu_plain_path(dev):
    cpu, card = _card_and_cpu_graphs(dev)
    roots = np.asarray([0, 5, 5, 191, 255] + list(range(20, 60)))
    want = MultiSourceBFSRunner(cpu, use_kernels=False,
                                packed=False).run(roots)
    kbu.reset_launches()
    runner = MultiSourceBFSRunner(card, packed=False)
    got = runner.run(roots)
    np.testing.assert_array_equal(got.levels, want.levels)
    assert got.host_transfers == want.host_transfers
    assert kbu.LAUNCHES["bitmap_update_batch"] >= got.iterations
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(card, use_kernels=False, packed=False)
    sssp = SSSPRunner(card, integrity="witness").run(roots)
    np.testing.assert_array_equal(sssp.distances, want.levels)


# -- K5: the paged CSR gather -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [0, 1, 17])
@pytest.mark.parametrize("page", [1, 3, 128, 512])
def test_gather_pages_kernel(dev, page, m):
    """Ids out of range on both sides: wrapped once, then clamped, as the
    plain version does; bit-exact."""
    num_pages = 7
    rng = np.random.default_rng(page + m)
    edges = _i(rng.integers(-2**31, 2**31 - 1, (num_pages, page)), dev)
    ids = _i(rng.integers(-3 * num_pages, 3 * num_pages, m), dev)
    kcg.reset_launches()
    got = kcg.gather_pages(edges, ids)
    assert kcg.LAUNCHES["gather_pages"] == (1 if m else 0)
    assert got.shape == (m, page) and got.dtype == torch.int32
    assert torch.equal(got, ref.gather_pages_ref(edges, ids))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [4, 128])
def test_gather_pages_kernel_misaligned_edges(dev, page):
    """An edge array 4 bytes off 16-byte alignment takes the scalar path
    and gives the same pages."""
    num_pages = 9
    flat = _i(np.random.default_rng(page).integers(0, 10**6,
                                                   num_pages * page + 1), dev)
    edges = flat[1:].view(num_pages, page)
    assert edges.data_ptr() % 16 == 4
    ids = _i([0, 8, 3, -1, 12, 5], dev)
    assert torch.equal(kcg.gather_pages(edges, ids),
                       ref.gather_pages_ref(edges, ids))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_read_neighbor_pages_on_card(dev):
    rng = np.random.default_rng(7)
    page = 64
    degrees = rng.integers(0, 200, 50)
    starts = np.concatenate([[0], np.cumsum(degrees)[:-1]])
    edges = rng.integers(0, 1000, -(-int(degrees.sum()) // page) * page)
    pids = ops.build_page_table(starts, degrees, page, 512)[0]
    got = ops.read_neighbor_pages(_i(edges, dev), _i(pids, dev), page)
    want = ops.read_neighbor_pages(_i(edges, "cpu"), _i(pids, "cpu"), page)
    assert torch.equal(got.cpu(), want)


# -- K6: the block-sparse pull SpMV -------------------------------------------

def _spmv_inputs(dev, b, lanes, nb, rb, cb, seed, brow=None, density=0.2):
    rng = np.random.default_rng(seed)
    tiles = (rng.random((nb, b, b)) < density).astype(np.float32)
    if brow is None:
        brow = np.sort(rng.integers(0, rb, nb))
    f = (rng.random((cb, b, lanes)) < 0.3).astype(np.float32)
    return (bf16_from_numpy(tiles, dev), _i(brow, dev),
            _i(rng.integers(0, cb, nb), dev), bf16_from_numpy(f, dev))


def _spmv_same(blocks, brow, bcol, f, rb):
    got = kps.pull_spmv_blocks(blocks, brow, bcol, None, f, rb)
    want = ref.pull_spmv_blocks_ref(blocks, brow, bcol, None, f, rb)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(ops.pull_spmv(blocks, brow, bcol, f, rb), want > 0)
    torch.cuda.synchronize()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4, 8, 64, 128])
@pytest.mark.parametrize("b", [16, 128, 256])
def test_pull_spmv_kernel(dev, b, lanes):
    """Bit-exact f32 (0/1 sums are exact in any order); row blocks 1 and 4
    have no tile and must be 0."""
    brow = [0, 0, 2, 2, 2, 3, 5, 5]
    args = _spmv_inputs(dev, b, lanes, len(brow), 6, 4, b + lanes, brow)
    kps.reset_launches()
    got = _spmv_same(*args, 6)
    assert kps.LAUNCHES["pull_spmv_blocks"] == 2      # direct + ops
    assert not got[[1, 4]].any()


@pytest.mark.cuda
def test_pull_spmv_kernel_single_tile_and_all_ones(dev):
    blocks, brow, bcol, f = _spmv_inputs(dev, 128, 8, 1, 1, 1, 3)
    _spmv_same(blocks, brow, bcol, f, 1)
    # the largest sums: all-ones tiles and frontier, 5 tiles on one row
    ones = torch.ones((5, 256, 256), dtype=torch.bfloat16, device=dev)
    f1 = torch.ones((2, 256, 64), dtype=torch.bfloat16, device=dev)
    got = _spmv_same(ones, _i([0, 0, 0, 0, 1], dev), _i([0, 1, 0, 1, 1], dev),
                     f1, 2)
    assert bool((got[0] == 4 * 256).all()) and bool((got[1] == 256).all())


@pytest.mark.cuda
def test_pull_spmv_kernel_out_of_range_blocks(dev):
    blocks, _, _, f = _spmv_inputs(dev, 16, 2, 6, 3, 3, 11, density=0.5)
    _spmv_same(blocks, _i([-1, 0, 3, -5, 1, 2], dev),
               _i([-1, 5, 0, -4, 2, -3], dev), f, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4, 64, 72])
@pytest.mark.parametrize("b", [40, 48])
def test_pull_spmv_kernel_ragged_tiles(dev, b, lanes):
    """b a multiple of 16 but not of 32 (48) or of 16 at all (40): the
    tensor-core kernel zero-pads the last k step; L = 72 is not a multiple
    of 16."""
    args = _spmv_inputs(dev, b, lanes, 9, 5, 3, 7 * b + lanes)
    _spmv_same(*args, 5)


@pytest.mark.cuda
def test_pull_spmv_kernel_lanes_72(dev):
    args = _spmv_inputs(dev, 128, 72, 12, 4, 4, 72)
    _spmv_same(*args, 4)


@pytest.mark.cuda
def test_pull_spmv_kernel_long_row_runs(dev):
    """About 600 tiles on 2 row blocks: each block's run of tiles lies
    inside a row or crosses from one row to the next."""
    brow = np.repeat([0, 1], [311, 290])
    blocks, brow_t, bcol, f = _spmv_inputs(dev, 128, 64, brow.size, 2, 8, 5,
                                           brow=brow, density=0.05)
    got = _spmv_same(blocks, brow_t, bcol, f, 2)
    assert got.max() > 1


@pytest.mark.cuda
def test_pull_spmv_kernel_unsorted_repeated_rows(dev):
    """1,000 tiles, so each block's run holds several: unsorted rows with
    repeats, negative rows that wrap and rows out of range that drop
    their tiles in the middle of a run."""
    rng = np.random.default_rng(17)
    brow = rng.integers(-6, 6, 1000)
    brow[:6] = [2, 2, 0, 2, 3, 3]
    args = _spmv_inputs(dev, 128, 64, brow.size, 4, 5, 17, brow=brow,
                        density=0.05)
    _spmv_same(*args, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lanes", [(128, 64), (256, 128), (64, 200)])
def test_pull_spmv_kernel_fewer_tiles_than_blocks(dev, b, lanes):
    """nb far below the blocks the grid would like (runs of one tile);
    b = 256 and L = 200 also split the output over grid y and z."""
    args = _spmv_inputs(dev, b, lanes, 3, 2, 2, b + lanes)
    _spmv_same(*args, 2)


@pytest.mark.cuda
def test_pull_spmv_kernel_misaligned_inputs(dev):
    """Tiles and frontier 2 bytes off 16-byte alignment take the scalar
    copies."""
    blocks, brow, bcol, f = _spmv_inputs(dev, 64, 16, 7, 3, 2, 23)
    pad_b = torch.zeros(blocks.numel() + 1, dtype=blocks.dtype, device=dev)
    pad_b[1:] = blocks.reshape(-1)
    pad_f = torch.zeros(f.numel() + 1, dtype=f.dtype, device=dev)
    pad_f[1:] = f.reshape(-1)
    mb, mf = pad_b[1:].view(blocks.shape), pad_f[1:].view(f.shape)
    assert mb.data_ptr() % 16 == 2 and mf.data_ptr() % 16 == 2
    _spmv_same(mb, brow, bcol, mf, 3)


# -- K7: flash attention ------------------------------------------------------

# (atol, rtol): |got - want| <= atol + rtol * |want|.  f32 both ways: only
# the order of the sums differs.  bf16 both ways: each side rounds its f32
# result once, so they differ by at most one bf16 ulp (under 2^-7 of the
# value); a flat 2e-2 would be as large as the outputs of long causal rows.
FLASH_TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (1e-3, 8e-3)}
FLASH_RMS = 1e-2    # rms(got - want) / rms(want)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bk", [(128, 64, 128), (256, 128, 64),
                                     (512, 64, 256)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, dtype, hd, s, bq, bk, causal):
    _flash_holds(dev, dtype, 2, s, hd, bq, bk, causal, hd + s)


def _flash_holds(dev, dtype, bh, s, hd, bq, bk, causal, seed):
    """One launch, held to FLASH_TOL elementwise and FLASH_RMS overall."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    kfa.reset_launches()
    got = kfa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert kfa.LAUNCHES["flash_attention"] == 1
    _flash_close(got, ref.flash_attention_ref(q, k, v, causal=causal))
    assert got.shape == q.shape


def _flash_close(got, want):
    """FLASH_TOL elementwise and FLASH_RMS overall, at want's dtype."""
    assert got.dtype == want.dtype
    atol, rtol = FLASH_TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    d = got.float() - want.float()
    assert float(d.square().mean().sqrt()
                 / want.float().square().mean().sqrt()) <= FLASH_RMS
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block", [(192, 64), (320, 64), (200, 40)])
def test_flash_attention_kernel_ragged_tiles(dev, s, block, causal):
    """S not a multiple of the bf16 kernel's 128-row query tile (192, 320),
    nor of its 64-key tile (200): rows past S unwritten, keys past S
    weightless."""
    _flash_holds(dev, torch.bfloat16, 3, s, 128, block, block, causal, s)


@pytest.mark.cuda
def test_flash_attention_kernel_long_row(dev):
    _flash_holds(dev, torch.bfloat16, 1, 4096, 128, 128, 128, True, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64])
def test_flash_attention_kernel_narrow_heads(dev, hd, causal):
    _flash_holds(dev, torch.bfloat16, 2, 1024, hd, 128, 256, causal, hd)


@pytest.mark.cuda
def test_flash_attention_kernel_misaligned_bf16(dev):
    """A contiguous bf16 view 2 bytes off 16-byte alignment is copied for
    the kernel's 16-byte loads: it gives the aligned input's result, and
    holds against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((2, 256, 64), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
    flat[1:] = q.reshape(-1)
    qm = flat[1:].view(q.shape)
    assert qm.data_ptr() % 16 == 2
    got = kfa.flash_attention(qm, k, v, block_q=64, block_k=64)
    assert torch.equal(got,
                       kfa.flash_attention(q, k, v, block_q=64, block_k=64))
    _flash_close(got, ref.flash_attention_ref(qm, k, v, causal=True))


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_cannot_take(dev):
    q = torch.zeros((1, 128, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention(q, q, q, block_q=64, block_k=64)
    h = torch.zeros((1, 128, 64), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        kfa.flash_attention(h, h, h, block_q=64, block_k=64)
    f = torch.zeros((1, 128, 64), device=dev)
    with pytest.raises(ValueError, match="divide"):
        kfa.flash_attention(f, f, f, block_q=96, block_k=64)


# -- the supervisor's ladder and audit on the card ------------------------------

class _NoKernelsOff:
    """Wraps a card runner's attribute writes: turning its kernels off
    fails the test (the card has no plain torch rung)."""

    def __init__(self, runner):
        cls = type(runner)

        def guard(self, name, value):
            if name == "use_kernels" and not value:
                raise AssertionError("use_kernels turned off on the card")
            object.__setattr__(self, name, value)

        runner.__class__ = type(f"Guarded{cls.__name__}", (cls,),
                                {"__setattr__": guard})
        self.runner = runner


@pytest.mark.cuda
def test_card_ladder_passes_over_the_torch_rung(dev):
    """Two kernel faults in one wave demote a card runner straight to the
    bool-plane rung (K3 on the card), whose rows equal the packed ones;
    the kernels stay on and the runner is packed again after the wave."""
    from repro_torch import ft
    _, card = _card_and_cpu_graphs(dev)
    roots = np.asarray([0, 5, 5, 191, 255] + list(range(20, 47)))
    runner = _NoKernelsOff(MultiSourceBFSRunner(card)).runner
    want = runner.run(roots).levels
    chaos = ft.FaultyEngine(runner, ft.FaultPlan([(0, "kernel"),
                                                  (1, "kernel")]))
    sup = ft.EngineSupervisor(chaos, backoff=0.0, watchdog=False,
                              max_retries=3)
    kbu.reset_launches()
    wave = sup.run_wave(roots)
    assert wave.demotions == ["kernels->boolplane"]
    assert wave.n_failed == 0
    np.testing.assert_array_equal(np.stack([o.levels for o in wave.outcomes]),
                                  want)
    assert kbu.LAUNCHES["bitmap_update_batch"] > 0
    assert runner.use_kernels is True and runner.packed is True


@pytest.mark.cuda
def test_card_demotion_scales_the_deadline_by_slack_squared(dev):
    from repro_torch import ft
    _, card = _card_and_cpu_graphs(dev)
    runner = _NoKernelsOff(MultiSourceBFSRunner(card)).runner
    chaos = ft.FaultyEngine(runner, ft.FaultPlan([(0, "kernel"),
                                                  (1, "kernel")]))
    sup = ft.EngineSupervisor(chaos, backoff=0.0, wave_deadline=2.0,
                              demotion_slack=3.0, sticky_demotions=True,
                              max_retries=3)
    assert sup.run_wave(np.arange(32)).n_failed == 0
    assert sup.current_deadline() == pytest.approx(18.0)
    assert runner.packed is False and runner.use_kernels is True


@pytest.mark.cuda
def test_card_kernel_fault_text_drives_the_ladder(dev):
    from repro_torch import ft
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError) as exc:
        _build.raise_on_error(700, "msbfs_propagate_planes")
    assert ft.is_kernel_fault(exc.value)
    assert ft.is_kernel_fault(RuntimeError(
        "nvcc failed for msbfs_propagate.cu (rc 1):\n..."))


@pytest.mark.cuda
def test_card_audit_of_a_boolplane_engine_returns(dev):
    """A bool-plane runner on the card has no rung left that the card may
    run: the audit tier returns without touching ``use_kernels``, and a
    packed runner's audit runs the bool-plane rung and agrees."""
    from repro_torch import ft
    _, card = _card_and_cpu_graphs(dev)
    roots = np.arange(40)
    for packed, audits in ((False, 0), (True, 2)):
        runner = _NoKernelsOff(MultiSourceBFSRunner(card,
                                                    packed=packed)).runner
        sup = ft.EngineSupervisor(runner, backoff=0.0, watchdog=False,
                                  integrity=ft.IntegrityConfig(
                                      mode="audit", audit_rate=1.0))
        for _ in range(2):
            assert sup.run_wave(roots).n_failed == 0
        st = sup.stats()["integrity"]
        assert st["audits"] == audits and st["audit_failures"] == 0
        assert runner.packed is packed and runner.use_kernels is True


# -- the distributed engine on a one-rank NCCL group -------------------------

def _dist_run(backend: str, store, device, **cfg):
    """Start a one-rank group, run the distributed engine on small-12-8
    (4 PEs) in it, destroy the group.  Returns (batch rows, batch stats,
    single-source levels, single-source stats, engine)."""
    import torch.distributed as dist
    from repro_torch.core import partition_graph
    from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
    from repro_torch.graph import get_dataset
    from repro_torch.launch.mesh import make_mesh
    ds = get_dataset("small-12-8")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1,), ("data",), device=device)
        eng = DistributedBFS(partition_graph(ds.csr, ds.csc, 4), mesh,
                             cfg=DistConfig(**cfg))
        rows = eng.run_batch(np.asarray([7, 100, 2000, 4095, 7]))
        batch_stats = dict(eng.last_stats)
        single = eng.run(100)
        return rows, batch_stats, single, dict(eng.last_stats), eng
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_distributed_one_rank_nccl_equals_cpu(dev, tmp_path, monkeypatch):
    """One rank, NCCL on the card (K2 on every pull level) against the same
    engine in a one-rank gloo group on the CPU (the plain path)."""
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path / "graphs"))
    want = _dist_run("gloo", tmp_path / "cpu", "cpu", use_kernels=False)
    kmod.reset_launches()
    got = _dist_run("nccl", tmp_path / "gpu", None)
    launched = kmod.LAUNCHES["msbfs_propagate_planes_tiled"]
    assert got[4].use_kernels and got[4].device.type == "cuda"
    for g, w in zip(got[:4], want[:4]):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert launched >= got[1]["pull_iters"] > 0


@pytest.mark.cuda
def test_distributed_cuda_mesh_refuses_plain_path(dev, tmp_path):
    import torch.distributed as dist
    from repro_torch.core import partition_graph
    from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
    from repro_torch.launch.mesh import make_mesh
    src, dst = np.random.default_rng(3).integers(0, 64, (2, 256))
    csr = csr_from_edges(src, dst, 64)
    pg = partition_graph(csr, transpose_csr(csr), 4)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1,), ("data",))
        with pytest.raises(ValueError, match="use_kernels=False"):
            DistributedBFS(pg, mesh, cfg=DistConfig(use_kernels=False))
        with pytest.raises(ValueError, match="gloo"):
            make_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_step_analysis_counts_equal_on_card_and_cpu(dev, tmp_path,
                                                    monkeypatch):
    """A packed wave and a single-source root count the same on the card
    as on the CPU (``use_kernels=True``, the wrappers' plain bodies), and
    the card's K1 and K4 calls are counted as often as they launch."""
    from repro_torch.graph import get_dataset
    from repro_torch.launch.step_analysis import StepAnalysis
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    ds = get_dataset("small-12-8")
    deg = np.diff(ds.csr.indptr)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 64,
                                            replace=False)
    counts, rows = {}, {}
    for d in (dev, "cpu"):
        g = build_local_graph(ds.csr, ds.csc, device=d)
        runner = BFSRunner(g, use_kernels=True)
        kmod.reset_launches()
        kbu.reset_launches()
        with StepAnalysis() as wave:
            rows[str(d)] = MultiSourceBFSRunner(
                g, use_kernels=True).run(roots).levels
        with StepAnalysis() as one:
            runner.run(int(roots[0]))
        counts[str(d)] = (wave.result(), wave.kernels, one.result(),
                          one.kernels)
        if d is dev:
            assert wave.kernels["msbfs_propagate_planes"]["calls"] == \
                kmod.LAUNCHES["msbfs_propagate_planes"] > 0
            assert one.kernels["bitmap_update"]["calls"] == \
                kbu.LAUNCHES["bitmap_update"] > 0
    np.testing.assert_array_equal(rows[str(dev)], rows["cpu"])
    assert counts[str(dev)] == counts["cpu"]


@pytest.mark.cuda
def test_dryrun_cell_on_the_card(dev, tmp_path):
    """One dry-run cell (lj-like, bitmap, staged, 2x16x16) on the card, in
    its own process: a record on the card with its peak bytes."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    path = tmp_path / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--bfs",
         "lj-like", "--multi-pod", "--json-out", str(path)], env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(path.read_text())
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert (rec["shards"], rec["verts_per_shard"], rec["edge_budget"]) == (
        512, 512, 7168)
    for phase in ("push", "pull"):
        assert rec[phase]["memory"]["peak_bytes"] > 0
        assert rec[phase]["per_device"]["bytes"] > 0


# -- the LM stack: the card against the CPU port, on the same weights ---------

def _lm_batch(cfg, b=2, s=16, enc=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32))}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32))
    if cfg.frontend == "audio_stub":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, enc, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    return batch


def _rms_ratio(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llava-next-34b", "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-30b-a3b", "whisper-small",
                                  "mamba2-370m", "llama3-8b",
                                  "h2o-danube-1.8b", "gemma3-4b",
                                  "llama3.2-3b", "recurrentgemma-2b"])
def test_lm_reduced_on_card_equals_cpu_port(dev, name):
    """bf16 weights from a CPU generator, copied to the card: the loss
    within 1e-2 and 4 ``serve_step`` positions' logits at an rms ratio of
    at most 2e-2 against the CPU port's."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as tt
    cfg = get_reduced_config(name)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0))
    card = tt.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    batch = _lm_batch(cfg)
    with torch.no_grad():
        want, _ = tt.loss_fn(cpu, cfg, batch)
        got, _ = tt.loss_fn(card, cfg, {k: v.to(dev)
                                        for k, v in batch.items()})
        assert abs(float(got) - float(want)) <= 1e-2
        caches = {d.type: tt.init_decode_state(cfg, 2, 8, enc_len=8,
                                               device=d)
                  for d in (torch.device("cpu"), dev)}
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 2), dtype=np.int32))
        for pos in range(4):
            lw, caches["cpu"] = tt.serve_step(cpu, cfg, caches["cpu"],
                                              tokens[pos], pos)
            lg, caches["cuda"] = tt.serve_step(card, cfg, caches["cuda"],
                                               tokens[pos].to(dev), pos)
            assert bool(torch.isfinite(lg).all())
            assert _rms_ratio(lg, lw) <= 2e-2, pos


@pytest.mark.cuda
def test_moe_layer_on_card_routes_as_cpu(dev):
    """One float32 MoE layer (qwen3-moe's reduced widths, 256 tokens):
    the same top-k indices and drops, outputs within 1e-4 + 1e-4·|want|."""
    from repro_torch.models import moe
    p = moe.MoE(64, 48, 8, torch.float32)
    p.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 128, 64), dtype=np.float32))
    kw = dict(top_k=4, capacity_factor=1.0, chunk=64)
    with torch.no_grad():
        pc = moe.MoE(64, 48, 8, torch.float32, dev)
        pc.load_state_dict(p.state_dict())
        idx_w, kept_w = moe.routing(x, p, **kw)
        idx_g, kept_g = moe.routing(x.to(dev), pc, **kw)
        assert torch.equal(idx_g.cpu(), idx_w)
        assert torch.equal(kept_g.cpu(), kept_w)
        assert 0 < int((~kept_w).sum())
        want, aux_w = moe.moe_forward(x, p, **kw)
        got, aux_g = moe.moe_forward(x.to(dev), pc, **kw)
    assert bool(((got.cpu() - want).abs()
                 <= 1e-4 + 1e-4 * want.abs()).all())
    assert abs(float(aux_g) - float(aux_w)) <= 1e-4 + 1e-4 * abs(float(aux_w))
