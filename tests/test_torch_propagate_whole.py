"""The whole-array propagate (K1) on the engine's edge list as it stands,
and the single-source P3 (K4) into ``out=`` buffers, against the
reference.

K1 takes src, tgt, the valid mask and the expansion's edge total as they
are and drops a slot itself (valid False, an index outside ``[0, n)``, a
slot at or after ``n_edges``).  The reference's oracle
``repro.kernels.ref.msbfs_propagate_planes_ref`` takes the older contract,
so its inputs are built the old way: a trash row appended (frontier 0,
seen all-ones) and every dropped slot pointed at it.  On the CPU the
wrappers run their plain versions; ``tests/test_torch_cuda.py`` holds the
CUDA kernels against those on the card.  Everything is bit-exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax                                           # noqa: E402
import torch                                         # noqa: E402

from repro.core import BFSRunner as JBFSRunner       # noqa: E402
from repro.core import SchedulerConfig as JSched     # noqa: E402
from repro.core import bfs_local as jbl              # noqa: E402
from repro.graph import get_dataset as j_get_dataset  # noqa: E402
from repro.kernels import ref as jref                # noqa: E402
from repro_torch.core import BFSRunner, SchedulerConfig, build_local_graph  # noqa: E402
from repro_torch.core import bfs_local as tbl        # noqa: E402
from repro_torch.graph import get_dataset            # noqa: E402
from repro_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from repro_torch.kernels import bitmap_update as kbu  # noqa: E402
from repro_torch.kernels import msbfs_propagate as kmod  # noqa: E402
from repro_torch.kernels import ops                  # noqa: E402

_planes_ref = jax.jit(jref.msbfs_propagate_planes_ref, static_argnames="op")

M = 300                          # edge slots of every case
CASES = ("valid holes", "n_edges 0", "n_edges inside", "n_edges = m",
         "n_edges beyond m", "out of range")


def _case(name: str, nw: int, seed: int):
    """(frontier, seen, src, tgt, valid, n_edges) as numpy, n = 41 rows."""
    rng = np.random.default_rng(seed)
    n = 41
    f = rng.integers(0, 2**32, (n, nw), dtype=np.uint32)
    f[rng.random(n) < 0.3] = 0                   # zero messages too
    s = rng.integers(0, 2**32, (n, nw), dtype=np.uint32)
    src = rng.integers(0, n, M).astype(np.int32)
    tgt = rng.integers(0, n, M).astype(np.int32)
    tgt[:40] = tgt[0]                            # colliding targets
    valid = np.ones(M, bool)
    n_edges = M
    if name == "valid holes":
        valid = rng.random(M) < 0.6
    elif name == "n_edges 0":
        n_edges = 0
    elif name == "n_edges inside":
        n_edges = 137
    elif name == "n_edges beyond m":
        n_edges = M + 50
    elif name == "out of range":
        src[::7] = rng.integers(-3, 0, src[::7].size)
        tgt[3::11] = n + rng.integers(0, 3, tgt[3::11].size)
        tgt[5::13] = -1
        valid = rng.random(M) < 0.9
        n_edges = 251
    return f, s, src, tgt, valid, n_edges


def _oracle(f, s, src, tgt, valid, n_edges, op):
    """The reference's oracle on trash-row inputs built the old way."""
    n, nw = f.shape
    ok = (valid & (src >= 0) & (src < n) & (tgt >= 0) & (tgt < n)
          & (np.arange(src.size) < n_edges))
    f1 = np.concatenate([f, np.zeros((1, nw), np.uint32)])
    s1 = np.concatenate([s, np.full((1, nw), 0xFFFFFFFF, np.uint32)])
    new, seen, cnt = _planes_ref(f1, s1, np.where(ok, src, n).astype(np.int32),
                                 np.where(ok, tgt, n).astype(np.int32), op=op)
    return (np.asarray(new)[:-1], np.asarray(seen)[:-1],
            int(np.asarray(cnt).reshape(())))


def _same(got, want):
    new, seen, cnt = got
    np.testing.assert_array_equal(planes_to_numpy(new), want[0])
    np.testing.assert_array_equal(planes_to_numpy(seen), want[1])
    assert int(cnt.reshape(())) == want[2]


def _t(a):
    if a.dtype == np.uint32:
        return planes_from_numpy(a, "cpu")
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("nw", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_whole_array_new_form_equals_reference(case, nw, op):
    """K1's plain version (valid and n_edges given) and
    ``ops.msbfs_propagate(tile_rows=0)`` equal the oracle; n_edges as a
    device int32 scalar, as the engine passes it."""
    f, s, src, tgt, valid, n_edges = _case(case, nw, seed=nw * 31 + len(case))
    want = _oracle(f, s, src, tgt, valid, n_edges, op)
    ne = torch.tensor(n_edges, dtype=torch.int32)
    args = (_t(f), _t(s), _t(src), _t(tgt))
    _same(kmod.msbfs_propagate_planes(*args, op=op, valid=_t(valid),
                                      n_edges=ne), want)
    _same(ops.msbfs_propagate(*args, _t(valid), op=op, tile_rows=0,
                              n_edges=ne), want)


@pytest.mark.parametrize("op", ["or", "max"])
@pytest.mark.parametrize("case", CASES)
def test_n_edges_forms_and_plans_agree(case, op):
    """n_edges as an int and as a tensor, and the tiled plan given the same
    n_edges, all equal the oracle; so does the older trash-row form."""
    f, s, src, tgt, valid, n_edges = _case(case, 2, seed=7 + len(case))
    want = _oracle(f, s, src, tgt, valid, n_edges, op)
    args = (_t(f), _t(s), _t(src), _t(tgt))
    _same(kmod.msbfs_propagate_planes(*args, op=op, valid=_t(valid),
                                      n_edges=n_edges), want)
    _same(ops.msbfs_propagate(*args, _t(valid), block_edges=32, op=op,
                              tile_rows=16,
                              n_edges=torch.tensor(n_edges,
                                                   dtype=torch.int32)), want)
    n = f.shape[0]
    ok = (valid & (src >= 0) & (src < n) & (tgt >= 0) & (tgt < n)
          & (np.arange(M) < n_edges))
    f1 = np.concatenate([f, np.zeros((1, 2), np.uint32)])
    s1 = np.concatenate([s, np.full((1, 2), 0xFFFFFFFF, np.uint32)])
    new, seen, cnt = kmod.msbfs_propagate_planes(
        _t(f1), _t(s1), _t(np.where(ok, src, n).astype(np.int32)),
        _t(np.where(ok, tgt, n).astype(np.int32)), op=op)
    _same((new[:-1], seen[:-1], cnt), want)


def test_no_edges_still_runs_p3():
    """m = 0 (the kernel form) gives new = 0, seen unchanged, count 0."""
    f, s, *_ = _case("valid holes", 2, seed=3)
    e = torch.zeros(0, dtype=torch.int32)
    new, seen, cnt = kmod.msbfs_propagate_planes(
        _t(f), _t(s), e, e, valid=torch.zeros(0, dtype=torch.bool),
        n_edges=torch.tensor(5, dtype=torch.int32))
    assert not bool(new.any()) and int(cnt.reshape(())) == 0
    np.testing.assert_array_equal(planes_to_numpy(seen), s)


# -- K4 into out= buffers, and the single-source runner's ping-pong ----------

def _words(w, seed):
    return np.random.default_rng(seed).integers(0, 2**32, w, dtype=np.uint32)


def _out(w):
    return (torch.empty(w, dtype=torch.int32), torch.empty(w, dtype=torch.int32),
            torch.empty((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("w", [1, 33, 1024])
def test_bitmap_update_out_buffers_equal_reference(w):
    c, v = _words(w, w), _words(w, w + 1)
    want = [np.asarray(a) for a in jref.bitmap_update_ref(c, v)]
    out = _out(w)
    got = kbu.bitmap_update(_t(c), _t(v), out=out)
    assert all(g is o for g, o in zip(got, out))
    np.testing.assert_array_equal(planes_to_numpy(out[0]), want[0])
    np.testing.assert_array_equal(planes_to_numpy(out[1]), want[1])
    assert int(out[2].reshape(())) == int(want[2].reshape(()))


def test_bitmap_update_out_refuses_aliases_and_bad_shapes():
    c, v = _t(_words(64, 1)), _t(_words(64, 2))
    new, vout, cnt = _out(64)
    for bad in ((c, vout, cnt), (new, v, cnt), (new, new, cnt),
                (new, vout, new[:1].view(1, 1)), (c[1:], vout, cnt)):
        with pytest.raises(ValueError):
            kbu.bitmap_update(c, v, out=bad)
    with pytest.raises(ValueError):
        kbu.bitmap_update(c, v, out=(new, vout, torch.empty(1, 1, 2,
                                                            dtype=torch.int32)))
    with pytest.raises(ValueError):
        kbu.bitmap_update(c, v, out=(new[:32], vout, cnt))


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
    """Make the runner read m_f = m_u = 1 from every statvec, so it budgets
    too few edges and must take the overflow retry path."""
    fetch = runner._fetch

    def spy(arr):
        out = np.array(fetch(arr))
        if out.shape == (7,):
            out[[tbl.SV_MF, tbl.SV_MU]] = 1
        return out

    runner._fetch = spy


@pytest.fixture(scope="module", autouse=True)
def graph_cache(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TORCH_GRAPH_CACHE",
              str(tmp_path_factory.mktemp("graphs")))
    yield
    mp.undo()


@pytest.mark.parametrize("policy", ["push", "pull", "beamer"])
def test_ping_pong_runner_equals_reference_with_retries(policy, monkeypatch):
    """The port's BFSRunner on the kernel path (K4's plain body into two
    alternating out sets) equals the reference's runner on every fetched
    statvec, the levels and the counters, with forced overflow retries;
    each P3 call writes the set its inputs do not lie in, and a retry
    rewrites the same set."""
    jds, tds = j_get_dataset("small-12-8"), get_dataset("small-12-8")
    jg = jbl.build_local_graph(jds.csr, jds.csc)
    tg = build_local_graph(tds.csr, tds.csc, device="cpu")
    root = int(np.argmax(np.diff(tds.csr.indptr)))
    jr = JBFSRunner(jg, JSched(policy=policy), init_budget=256,
                    use_pallas=False)
    _understating(jr)
    j_fetch = _recording(jr)
    jres = jr.run(root)

    tr = BFSRunner(tg, SchedulerConfig(policy=policy), init_budget=256,
                   use_kernels=True)
    sets = [tuple(t.data_ptr() for t in s) for s in tr._p3_out]
    assert len(set(sets[0] + sets[1])) == 6
    calls = []
    orig = kbu.bitmap_update

    def spy(cand, visited, out=None):
        calls.append((visited.data_ptr(), tuple(t.data_ptr() for t in out)))
        return orig(cand, visited, out=out)

    monkeypatch.setattr(kbu, "bitmap_update", spy)
    monkeypatch.setattr(ops, "bitmap_update", spy)
    _understating(tr)
    t_fetch = _recording(tr)
    tres = tr.run(root)

    assert tres.overflow_retries > 0
    np.testing.assert_array_equal(tres.level, jres.level)
    for k in ("iterations", "edges_inspected", "push_iters", "pull_iters",
              "traversed_edges", "host_transfers"):
        assert getattr(tres, k) == getattr(jres, k), k
    assert len(t_fetch) == len(j_fetch)
    for a, b in zip(t_fetch, j_fetch):
        np.testing.assert_array_equal(a, b)
    assert len(calls) == tres.iterations + tres.overflow_retries
    for vis, out in calls:
        assert out in sets and vis not in out
    # levels alternate between the two sets; retries stay on theirs
    used = [sets.index(out) for _, out in calls]
    assert used[0] == 0 and set(used) == {0, 1}
