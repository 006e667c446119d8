"""The CUDA kernels on the card against their plain versions, bit for bit.

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
from repro_torch.interop import planes_from_numpy
from repro_torch.kernels import bitmap_update as kbu
from repro_torch.kernels import msbfs_propagate as kmod
from repro_torch.kernels import ops, ref

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
    k2 = ops._tiled_inputs(seen, ops._gather_msgs(frontier, src, ok), tgt,
                           ok, TILE, BLOCK)
    _same(kmod.msbfs_propagate_planes_tiled(*k2, TILE, BLOCK, op=op),
          ref.msbfs_propagate_planes_tiled_ref(*k2, TILE, BLOCK, op=op))
    whole = ops.msbfs_propagate(frontier, seen, src, tgt, valid,
                                block_edges=BLOCK, op=op, tile_rows=0)
    tiled = ops.msbfs_propagate(frontier, seen, src, tgt, valid,
                                block_edges=BLOCK, op=op, tile_rows=TILE)
    _same(whole, tiled)
    torch.cuda.synchronize()


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
