"""The port's single-source BFS against the reference's.

The same graphs and roots go through ``repro.core.BFSRunner`` (with
``use_pallas=False``, and ``True``, which runs the Pallas P3 kernel
``bitmap_update`` in interpret mode) and the port's ``BFSRunner`` on the
CPU (``use_kernels=False``, and ``True``, which runs the K4 wrapper's
plain body).  Levels, every fetched statvec, ``iterations``,
``edges_inspected``, the push/pull split and ``host_transfers`` must be
identical; the dense ``bfs_reference`` of both packages and the
pure-Python oracle must agree with them.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp                                    # noqa: E402
import torch                                               # noqa: E402

from repro.core import BFSRunner as JBFSRunner             # noqa: E402
from repro.core import SchedulerConfig as JSched           # noqa: E402
from repro.core import bfs_local as jbl                    # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import get_dataset as j_get_dataset       # noqa: E402
from repro.graph import rmat_edges as j_rmat_edges         # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro_torch.core import (BFSRunner, SchedulerConfig, bfs_oracle,  # noqa: E402
                              bfs_reference, build_local_graph)
from repro_torch.core import bfs_local as tbl              # noqa: E402
from repro_torch.graph import csr_from_edges, get_dataset, transpose_csr  # noqa: E402
from repro_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from repro_torch.kernels import bitmap_update as kbu       # noqa: E402

FIELDS = ("iterations", "edges_inspected", "push_iters", "pull_iters",
          "traversed_edges", "host_transfers")


@pytest.fixture(scope="module", autouse=True)
def graph_cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TORCH_GRAPH_CACHE",
              str(tmp_path_factory.mktemp("graphs")))
    yield
    mp.undo()


def _pair(name):
    """(reference csr, reference LocalGraph, port csr, port LocalGraph)."""
    jds, tds = j_get_dataset(name), get_dataset(name)
    return (jds.csr, jbl.build_local_graph(jds.csr, jds.csc), tds.csr,
            build_local_graph(tds.csr, tds.csc, device="cpu"))


def _edges_pair(src, dst, n):
    jc = j_csr_from_edges(src, dst, n)
    tc = csr_from_edges(src, dst, n)
    return (jc, jbl.build_local_graph(jc, j_transpose_csr(jc)), tc,
            build_local_graph(tc, transpose_csr(tc), device="cpu"))


def _recording(runner):
    """Record every array the runner fetches (statvecs, then levels)."""
    seen = []
    fetch = runner._fetch

    def spy(arr):
        out = fetch(arr)
        seen.append(np.array(out))
        return out

    runner._fetch = spy
    return seen


def _understating(runner):
    """Make the runner read m_f = m_u = 1 from every statvec it fetches,
    so it budgets too few edges and must take the overflow retry path."""
    fetch = runner._fetch

    def spy(arr):
        out = np.array(fetch(arr))
        if out.shape == (7,):
            out[[tbl.SV_MF, tbl.SV_MU]] = 1
        return out

    runner._fetch = spy


def _hub(csr) -> int:
    """The highest-degree vertex: its traversal has wide levels."""
    return int(np.argmax(np.diff(csr.indptr)))


def _check_same_run(jg, tg, csr, root, sched_kw=None, init_budget=1 << 15,
                    pallas=(False, True), understate=False):
    """Run both packages on ``root``; every observable must agree."""
    sched_kw = sched_kw or {}
    results = []
    for use_pallas in pallas:
        jr = JBFSRunner(jg, JSched(**sched_kw), init_budget=init_budget,
                        use_pallas=use_pallas)
        if understate:
            _understating(jr)
        j_fetch = _recording(jr)
        jres = jr.run(root)
        for use_kernels in (False, True):
            tr = BFSRunner(tg, SchedulerConfig(**sched_kw),
                           init_budget=init_budget, use_kernels=use_kernels)
            if understate:
                _understating(tr)
            t_fetch = _recording(tr)
            tres = tr.run(root)
            np.testing.assert_array_equal(tres.level, jres.level)
            for k in FIELDS:
                assert getattr(tres, k) == getattr(jres, k), k
            assert len(t_fetch) == len(j_fetch)
            for a, b in zip(t_fetch, j_fetch):
                np.testing.assert_array_equal(a, b)
            assert tres.host_transfers == (tres.iterations + 2
                                           + tres.overflow_retries)
            results.append(tres)
    np.testing.assert_array_equal(results[0].level.astype(np.int64),
                                  bfs_oracle(csr, root))
    return results[0]


def test_bfs_reference_matches_reference_and_oracle():
    jc, jg, tc, tg = _pair("tiny-16-4")
    for root in (0, 3, 7, 15):
        got = bfs_reference(tg, root).numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(jbl.bfs_reference(jg, root)))
        np.testing.assert_array_equal(got.astype(np.int64),
                                      bfs_oracle(tc, root))


@pytest.mark.parametrize("policy", ["push", "pull", "beamer", "paper"])
def test_runner_matches_reference_runner(policy):
    jc, jg, tc, tg = _pair("small-12-8")
    res = _check_same_run(jg, tg, tc, _hub(tc), dict(policy=policy))
    if policy == "beamer":
        assert res.push_iters and res.pull_iters     # both directions ran


def test_directed_graph():
    src, dst = j_rmat_edges(6, 4, seed=9)
    jc, jg, tc, tg = _edges_pair(src, dst, 64)
    for root in (1, 40):
        _check_same_run(jg, tg, tc, root)


def test_awkward_graph_isolated_root_and_self_loops():
    """Isolated vertices (a root among them) and self-loops."""
    rng = np.random.default_rng(3)
    n, hi = 128, 96
    loops = np.arange(0, hi, 16)
    src = np.concatenate([rng.integers(0, hi, 300), loops])
    dst = np.concatenate([rng.integers(0, hi, 300), loops])
    jc, jg, tc, tg = _edges_pair(src, dst, n)
    for root in (16, n - 1):
        _check_same_run(jg, tg, tc, root)


@pytest.mark.parametrize("policy", ["push", "beamer"])
def test_forced_overflow_retries(policy):
    """The statvecs' edge counts are understated, so a 256-edge budget
    overflows on the wide levels: each retry doubles it and is one more
    transfer, in both packages alike."""
    jc, jg, tc, tg = _pair("small-12-8")
    res = _check_same_run(jg, tg, tc, _hub(tc), dict(policy=policy),
                          init_budget=256, pallas=(False,), understate=True)
    assert res.overflow_retries > 0


def test_hybrid_inspects_fewer_edges_than_pure_modes():
    """Paper Fig. 8 on the port: hybrid <= push and <= pull."""
    *_, tc, tg = _pair("small-12-8")
    res = {p: BFSRunner(tg, SchedulerConfig(policy=p)).run(_hub(tc))
           for p in ("push", "pull", "beamer")}
    assert res["beamer"].edges_inspected <= res["push"].edges_inspected
    assert res["beamer"].edges_inspected <= res["pull"].edges_inspected


def test_single_source_state_carried_across():
    """The reference's single-source state (flat uint32 words, the level
    row, the int32[7] statvec) carried into the port through
    ``interop`` gives the reference's next step, push and pull."""
    jc, jg, tc, tg = _pair("small-12-8")
    root = _hub(tc)
    jf, jv, jl, jsv = jbl._sbfs_init(jg, jnp.asarray([root], jnp.int32))
    tf, tv, tl, tsv = tbl._sbfs_init(tg, torch.tensor([root]))
    np.testing.assert_array_equal(planes_to_numpy(tf), np.asarray(jf))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    carried = (planes_from_numpy(np.asarray(jf), "cpu"),
               planes_from_numpy(np.asarray(jv), "cpu"),
               torch.from_numpy(np.array(jl)))
    assert carried[0].shape == (tg.n_pad // 32,)
    for jstep, tstep in ((jbl.push_step, tbl.push_step),
                         (jbl.pull_step, tbl.pull_step)):
        want = jstep(jg, jf, jv, jl, np.int32(0), 1 << 15)
        for use_kernels in (False, True):
            got = tstep(tg, *carried, 0, 1 << 15, use_kernels)
            np.testing.assert_array_equal(planes_to_numpy(got[0]),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(planes_to_numpy(got[1]),
                                          np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(),
                                          np.asarray(want[2]))
            np.testing.assert_array_equal(got[3].numpy(),
                                          np.asarray(want[3]))


def test_flat_bitmap_helpers_match_reference():
    """from_indices / from_indices_dense (with -1 and out-of-range
    indices dropped), test_bits with bit 31, np_unpack, zeros.

    The reference's ``from_indices`` (no caller in either package) keeps
    the max of the bits aimed at one word, not their OR: its
    ``_scatter_or`` max-scatters one bit-plane after another into words
    that already hold bits.  The port's is an OR, so it is held against
    the reference's ``from_indices_dense`` and, where each word gets at
    most one bit, against ``from_indices`` itself."""
    from repro.core import bitmap as jbm
    from repro_torch.core import bitmap as tbm
    for nbits in (1, 31, 32, 100, 1024):
        idx = np.asarray([-1, 0, nbits - 1, nbits, nbits + 40, 31, 31, 5],
                         np.int32)
        want = np.asarray(jbm.from_indices_dense(jnp.asarray(idx), nbits))
        for tf in (tbm.from_indices, tbm.from_indices_dense):
            got = planes_to_numpy(tf(torch.from_numpy(idx), nbits))
            np.testing.assert_array_equal(got, want)
        one_per_word = np.asarray([-1, nbits - 1, nbits + 3], np.int32)
        np.testing.assert_array_equal(
            planes_to_numpy(tbm.from_indices(torch.from_numpy(one_per_word),
                                             nbits)),
            np.asarray(jbm.from_indices(jnp.asarray(one_per_word), nbits)))
        assert tuple(tbm.zeros(nbits).shape) == np.asarray(
            jbm.zeros(nbits)).shape
    words = np.random.default_rng(0).integers(0, 2**32, 8, dtype=np.uint32)
    words[3] |= 1 << 31
    probe = np.arange(8 * 32, dtype=np.int32)
    np.testing.assert_array_equal(
        tbm.test_bits(planes_from_numpy(words, "cpu"),
                      torch.from_numpy(probe)).numpy(),
        np.asarray(jbm.test_bits(jnp.asarray(words), jnp.asarray(probe))))
    np.testing.assert_array_equal(
        tbm.np_unpack(words.view(np.int32), 200), jbm.np_unpack(words, 200))


def test_root_validated_and_kernel_rule():
    *_, tg = _pair("tiny-16-4")
    for bad in (-1, 16):
        with pytest.raises(ValueError):
            BFSRunner(tg).run(bad)
    assert BFSRunner(tg).use_kernels is False          # graph on the CPU
    kbu.reset_launches()
    BFSRunner(tg, use_kernels=True).run(0)
    assert kbu.LAUNCHES["bitmap_update"] == 0          # plain body on CPU
