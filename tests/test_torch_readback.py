"""The engines' final readback: ``core.readback.PinnedPool`` and the two
runners around it.

The pool's ownership bookkeeping runs here on ordinary host tensors
standing in for page-locked ones (``HostPool`` engages on CPU tensors and
allocates plain memory): a block goes back into use only once no array,
view or tensor of the answer it holds is alive, and the counters say how
often a readback had to grow the pool.  On a CPU graph the runners read
back exactly as before (``.cpu()``, no pool counts); with ``HostPool`` in
their place they run the pool's path on the CPU and return the same rows.
The card's own path is in ``test_torch_cuda.py``.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import (BFSRunner, MultiSourceBFSRunner, bfs_oracle,
                              build_local_graph, msbfs_reference)
from repro_torch.core.readback import PinnedPool
from repro_torch.graph import csr_from_edges, transpose_csr
from repro_torch.launch.dynbatch import DynamicBatcher


class HostPool(PinnedPool):
    """The pool on the CPU: engages on CPU tensors, plain host blocks."""

    device_type = "cpu"

    def __init__(self):
        super().__init__()
        self.made: list[int] = []

    def alloc(self, nbytes):
        self.made.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)


def _read(pool, t):
    """One readback, as the runners make it: admit, then fetch."""
    pool.admit(t)
    return pool.fetch(t)


def _wave(i, shape=(4, 8)):
    return torch.arange(np.prod(shape), dtype=torch.int32).reshape(
        shape) + 1000 * i


def _graph():
    rng = np.random.default_rng(3)
    n = 300
    src, dst = rng.integers(0, 250, 1800), rng.integers(0, 250, 1800)
    csr = csr_from_edges(src, dst, n)
    return csr, build_local_graph(csr, transpose_csr(csr), device="cpu")


ROOTS = np.asarray([0, 5, 5, 249, 299] + list(range(20, 47)))


# -- the pool ------------------------------------------------------------------

def test_held_answers_keep_their_values_across_three_readbacks():
    pool = HostPool()
    whole = _read(pool, _wave(0))                # a result, held whole
    row = _read(pool, _wave(1))[1]               # a row view of a result
    copied = np.ascontiguousarray(_read(pool, _wave(2))[2])
    as_tensor = torch.from_numpy(_read(pool, _wave(3)))
    for i in (4, 5, 6):
        got = _read(pool, _wave(i))
        np.testing.assert_array_equal(got, _wave(i).numpy())
        del got
    np.testing.assert_array_equal(whole, _wave(0).numpy())
    np.testing.assert_array_equal(row, _wave(1).numpy()[1])
    np.testing.assert_array_equal(copied, _wave(2).numpy()[2])
    assert torch.equal(as_tensor, _wave(3))
    # four answers held, and one more block for the three later ones
    assert pool.stats()["blocks"] == 5 and pool.grown == 5
    assert pool.readbacks == 7


def test_block_is_reused_only_after_every_reference_is_dropped():
    pool = HostPool()
    res = _read(pool, _wave(0))
    ptr = res.__array_interface__["data"][0]
    row, contiguous = res[1], np.ascontiguousarray(res[2])
    del res
    gc.collect()
    other = _read(pool, _wave(1))                # the row still holds it
    assert other.__array_interface__["data"][0] != ptr
    assert pool.grown == 2
    del row
    third = _read(pool, _wave(2))                # the copy-free row does too
    assert third.__array_interface__["data"][0] != ptr
    assert pool.grown == 3
    del contiguous, other, third
    got = _read(pool, _wave(3))
    assert pool.grown == 3 and pool.stats()["blocks"] == 3
    np.testing.assert_array_equal(got, _wave(3).numpy())


def test_counters_count_growth_and_reuse():
    pool = HostPool()
    assert pool.stats() == dict(readbacks=0, grown=0, blocks=0,
                                pinned_bytes=0, reuse_share=None)
    held = None
    for i in range(8):                           # a closed loop: the
        held = _read(pool, _wave(i))             # previous answer is held
    del held
    st = pool.stats()
    assert (st["readbacks"], st["grown"], st["blocks"]) == (8, 2, 2)
    assert st["pinned_bytes"] == 2 * 4 * 32
    assert st["reuse_share"] == pytest.approx(6 / 8)
    assert pool.made == [128, 128]


def test_a_larger_payload_releases_the_smaller_free_blocks():
    pool = HostPool()
    small = [_read(pool, _wave(i, (2, 8))) for i in range(2)]
    del small
    big = _read(pool, _wave(2, (4, 8)))          # neither 64-byte block fits
    assert pool.stats()["blocks"] == 1 and pool.grown == 3
    del big
    again = _read(pool, _wave(3, (2, 8)))        # the big block serves it
    assert pool.grown == 3 and again.shape == (2, 8)
    np.testing.assert_array_equal(again, _wave(3, (2, 8)).numpy())


def test_admit_counts_the_readback_before_the_fetch():
    pool = HostPool()
    t = _wave(0)
    st = pool.admit(t)
    assert (st["readbacks"], st["grown"], st["blocks"]) == (1, 1, 1)
    got = pool.fetch(t)
    assert pool.stats()["readbacks"] == 1 and pool.made == [128]
    assert got.dtype == np.int32 and got.flags.c_contiguous
    assert got.flags.writeable
    statvec = _wave(1, (8,))                     # fetched, never admitted
    np.testing.assert_array_equal(pool.fetch(statvec), statvec.numpy())
    assert pool.stats()["readbacks"] == 1 and pool.made == [128]


def test_an_admission_never_fetched_leaves_its_block_free():
    pool = HostPool()
    pool.admit(_wave(0))
    got = pool.fetch(_wave(1))                   # not the admitted tensor
    assert pool.grown == 1 and pool.made == []
    del got
    got = _read(pool, _wave(2))
    assert pool.grown == 1 and pool.readbacks == 2
    np.testing.assert_array_equal(got, _wave(2).numpy())


def test_the_pool_does_not_engage_on_another_device():
    pool = PinnedPool()                          # engages on the card only
    t = _wave(0)
    assert pool.admit(t) is None
    got = pool.fetch(t)
    np.testing.assert_array_equal(got, t.numpy())
    assert pool.stats()["readbacks"] == 0


# -- the runners --------------------------------------------------------------

@pytest.mark.parametrize("integrity", ["off", "witness"])
def test_multi_source_runner_on_a_cpu_graph_reads_back_as_before(integrity):
    _, g = _graph()
    runner = MultiSourceBFSRunner(g, integrity=integrity)
    res = runner.run(ROOTS)
    want = msbfs_reference(g, torch.from_numpy(ROOTS)).numpy()
    np.testing.assert_array_equal(res.levels, want)
    assert res.levels.dtype == np.int32 and res.levels.flags.c_contiguous
    assert res.levels.shape == (ROOTS.size, g.n)
    assert res.host_transfers == res.iterations + 2
    assert "readback" not in runner.last_stats
    assert runner.readback_stats["readbacks"] == 0


def test_single_source_runner_on_a_cpu_graph_reads_back_as_before():
    csr, g = _graph()
    runner = BFSRunner(g)
    for root in (0, 5, 249):
        res = runner.run(root)
        np.testing.assert_array_equal(res.level, bfs_oracle(csr, root))
        assert res.level.dtype == np.int32 and res.level.flags.c_contiguous
        assert res.host_transfers == res.iterations + 2
    assert runner.readback_stats["readbacks"] == 0


@pytest.mark.parametrize("integrity", ["off", "witness"])
def test_multi_source_runner_through_the_pool(integrity):
    _, g = _graph()
    plain = MultiSourceBFSRunner(g, integrity=integrity)
    runner = MultiSourceBFSRunner(g, integrity=integrity)
    runner._readback = HostPool()
    held, wants = [], []
    for i in range(5):
        roots = np.roll(ROOTS, i)
        res = runner.run(roots)
        want = plain.run(roots)
        np.testing.assert_array_equal(res.levels, want.levels)
        assert res.levels.dtype == np.int32
        assert res.levels.flags.c_contiguous
        assert res.host_transfers == res.iterations + 2
        assert res.traversed_edges == want.traversed_edges
        assert runner.last_stats["readback"]["readbacks"] == i + 1
        if i < 2:                                # hold the first two waves
            held.append(res.levels[i])
            wants.append(want.levels[i].copy())
    for got, want in zip(held, wants):
        np.testing.assert_array_equal(got, want)
    st = runner.readback_stats
    # two held; each run also sees the previous ``res`` alive, as a closed
    # loop does, so waves three to five take turns on two more blocks
    assert (st["readbacks"], st["grown"], st["blocks"]) == (5, 4, 4)


def test_single_source_runner_through_the_pool():
    csr, g = _graph()
    runner = BFSRunner(g)
    runner._readback = HostPool()
    levels = [runner.run(root).level for root in (0, 5, 249, 17)]
    for root, got in zip((0, 5, 249, 17), levels):
        want = BFSRunner(g).run(root)
        np.testing.assert_array_equal(got, want.level)
    assert runner.readback_stats["grown"] == 4
    del levels
    res = runner.run(3)
    assert res.host_transfers == res.iterations + 2
    assert runner.readback_stats["grown"] == 4


def test_batcher_futures_keep_their_rows_through_the_pool():
    _, g = _graph()
    runner = MultiSourceBFSRunner(g)
    runner._readback = HostPool()
    plain = MultiSourceBFSRunner(g)
    batcher = DynamicBatcher(runner, window=0.0, max_batch=8)
    try:
        first = batcher.submit(17).result(timeout=60)
        for root in (3, 40, 99):
            batcher.submit(root).result(timeout=60)
    finally:
        batcher.close(drain=True, timeout=60)
    np.testing.assert_array_equal(first, plain.run(np.asarray([17])).levels[0])
    assert runner.readback_stats["readbacks"] == 4
