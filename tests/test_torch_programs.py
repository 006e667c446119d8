"""The port's other vertex programs and engine modes against the reference.

Each case runs the reference's runner (``use_pallas=False`` unless stated)
and the port's on the CPU, on the same graph and roots: CC labels and
component counts, SSSP distances (also against a dense Bellman–Ford and
against BFS), the bool-plane baseline ``packed=False`` (against the
reference with ``use_pallas=True``, which runs the Pallas P3 kernel
``bitmap_update_batch`` in interpret mode), integrity checking (the
int32[8] statvecs, the witness verdict at one ``integrity_seed``, and
``IntegrityError`` on an injected flip), overflow control
(``BudgetOverflowError``, ``budget=``) and ``build_engine(algo=...)``.
Everything is compared exactly.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp                                    # noqa: E402
import torch                                               # noqa: E402

import repro.core.vertex_program as jvp                    # noqa: E402
from repro.core import BudgetOverflowError as JBudgetOverflowError  # noqa: E402
from repro.core import ConnectedComponentsRunner as JCC    # noqa: E402
from repro.core import IntegrityError as JIntegrityError   # noqa: E402
from repro.core import MultiSourceBFSRunner as JMS         # noqa: E402
from repro.core import SSSPRunner as JSSSP                 # noqa: E402
from repro.core import SchedulerConfig as JSched           # noqa: E402
from repro.core import bfs_local as jbl                    # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import symmetrize_csr as j_symmetrize_csr  # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro.launch import serve as jserve                   # noqa: E402
import repro_torch.core.vertex_program as tvp              # noqa: E402
from repro_torch.core import (CC, SSSP, BudgetOverflowError,  # noqa: E402
                              ConnectedComponentsRunner, IntegrityError,
                              MultiSourceBFSRunner, SchedulerConfig,
                              SSSPRunner, bfs_oracle, build_local_graph,
                              get_program, vp_reference)
from repro_torch.core import bfs_local as tbl              # noqa: E402
from repro_torch.graph import (csr_from_edges, symmetrize_csr,  # noqa: E402
                               transpose_csr)
from repro_torch.interop import planes_from_numpy, planes_to_numpy  # noqa: E402
from repro_torch.kernels import bitmap_update as kbu       # noqa: E402
from repro_torch.launch import serve                       # noqa: E402

N = 128
INF = 1 << 30


def _awkward_edges(n: int, m: int, seed: int):
    """Edges confined to the first 3n/4 vertices (the last quarter is
    isolated), plus a self-loop on every 16th active vertex."""
    rng = np.random.default_rng(seed)
    hi = (3 * n) // 4
    loops = np.arange(0, hi, 16)
    return (np.concatenate([rng.integers(0, hi, m), loops]),
            np.concatenate([rng.integers(0, hi, m), loops]))


def _graphs(src, dst, n=N):
    """(reference csr, reference LocalGraph, port csr, port LocalGraph)."""
    jc = j_csr_from_edges(src, dst, n)
    tc = csr_from_edges(src, dst, n)
    return (jc, jbl.build_local_graph(jc, j_transpose_csr(jc)), tc,
            build_local_graph(tc, transpose_csr(tc), device="cpu"))


def _roots(batch: int, seed: int) -> np.ndarray:
    """Roots including an isolated vertex and a self-loop vertex."""
    roots = np.random.default_rng(seed).choice(N, batch, replace=False)
    if batch >= 2:
        roots[0], roots[1] = N - 1, 16
    return roots.astype(np.int32)


def _recording(runner):
    seen = []
    fetch = runner._fetch

    def spy(arr):
        out = fetch(arr)
        seen.append(np.array(out))
        return out

    runner._fetch = spy
    return seen


def _stats(runner):
    """``last_stats`` less its wall-clock seconds and the port's own
    ``budget_slots`` (the reference counts no written slots)."""
    return {k: v for k, v in runner.last_stats.items()
            if k not in ("seconds", "budget_slots")}


def _same_run(jr, tr, roots, **run_kw):
    """Run both; levels, last_stats and every statvec the reference
    fetched through ``_fetch`` must be identical.  Returns both results."""
    j_fetch, t_fetch = _recording(jr), _recording(tr)
    jres, tres = jr.run(roots, **run_kw), tr.run(roots, **run_kw)
    np.testing.assert_array_equal(tres.levels, jres.levels)
    assert _stats(tr) == _stats(jr)
    assert len(t_fetch) >= len(j_fetch)
    for a, b in zip(t_fetch, j_fetch):
        np.testing.assert_array_equal(a, b)
    return jres, tres


def _bellman_ford(csr, root: int) -> np.ndarray:
    """Dense unit-weight Bellman–Ford: relax every edge until fixpoint."""
    n = csr.indptr.size - 1
    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    dist = np.full(n, INF, np.int64)
    dist[root] = 0
    for _ in range(n):
        nd = dist.copy()
        np.minimum.at(nd, csr.indices, np.minimum(dist[src] + 1, INF))
        if (nd == dist).all():
            break
        dist = nd
    return dist


def _union_find_labels(csr, seeds) -> np.ndarray:
    """label[v] = min seed id in v's undirected component, else -1."""
    n = csr.indptr.size - 1
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    for u, v in zip(src, csr.indices):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    best = {}
    for s in seeds:
        r = find(int(s))
        best[r] = min(best.get(r, int(s)), int(s))
    return np.asarray([best.get(find(v), -1) for v in range(n)])


# ---------------------------------------------------------------------------
# CC and SSSP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 32, 48])
def test_cc_matches_reference(batch):
    src, dst = _awkward_edges(N, 200, seed=batch)
    jc, tc = j_csr_from_edges(src, dst, N), csr_from_edges(src, dst, N)
    roots = _roots(batch, seed=batch + 1)
    jr = JCC.from_csr(jc, use_pallas=False)
    tr = ConnectedComponentsRunner.from_csr(tc, device="cpu",
                                            use_kernels=False)
    jres, tres = _same_run(jr, tr, roots)
    np.testing.assert_array_equal(tres.labels, jres.labels)
    assert tr.last_stats["components"] == jr.last_stats["components"]
    np.testing.assert_array_equal(tres.labels,
                                  _union_find_labels(tc, roots))
    assert tres.host_transfers == tres.iterations + 2
    kres = ConnectedComponentsRunner.from_csr(tc, device="cpu",
                                              use_kernels=True).run(roots)
    np.testing.assert_array_equal(kres.labels, jres.labels)


@pytest.mark.parametrize("batch", [1, 32, 48])
def test_sssp_matches_reference_bellman_ford_and_bfs(batch):
    src, dst = _awkward_edges(N, 300, seed=10 + batch)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(batch, seed=batch)
    jres, tres = _same_run(JSSSP(jg, use_pallas=False),
                           SSSPRunner(tg, use_kernels=False), roots)
    kres = SSSPRunner(tg, use_kernels=True).run(roots)
    np.testing.assert_array_equal(kres.distances, jres.distances)
    bfs = MultiSourceBFSRunner(tg, use_kernels=False).run(roots)
    np.testing.assert_array_equal(tres.distances, bfs.levels)
    for i, r in enumerate(roots):
        np.testing.assert_array_equal(tres.distances[i].astype(np.int64),
                                      _bellman_ford(tc, int(r)))
    assert tres.host_transfers == tres.iterations + 2


def test_minplus_commit_and_programs():
    value = torch.tensor([[0, INF], [3, INF], [INF, 2]], dtype=torch.int32)
    mask = torch.tensor([[True, True], [True, False], [False, True]])
    got = tvp.minplus_commit(value, mask, 1)
    want = jvp.minplus_commit(jnp.asarray(value.numpy()),
                              jnp.asarray(mask.numpy()), 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert get_program("cc") is CC and CC.undirected
    assert get_program("sssp") is SSSP and not SSSP.undirected
    for bad in ("pagerank", ""):
        with pytest.raises(ValueError):
            get_program(bad)


@pytest.mark.parametrize("program", ["cc", "sssp"])
def test_vp_reference_matches_reference(program):
    src, dst = _awkward_edges(N, 250, seed=5)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(33, seed=2)
    got = vp_reference(tg, roots, get_program(program)).numpy()
    want = np.asarray(jvp.vp_reference(jg, jnp.asarray(roots),
                                       jvp.get_program(program)))
    np.testing.assert_array_equal(got, want)


def test_symmetrize_csr_matches_reference():
    src, dst = _awkward_edges(N, 300, seed=8)
    sym, jsym = (symmetrize_csr(csr_from_edges(src, dst, N)),
                 j_symmetrize_csr(j_csr_from_edges(src, dst, N)))
    np.testing.assert_array_equal(sym.indptr, jsym.indptr)
    np.testing.assert_array_equal(sym.indices, jsym.indices)
    back = transpose_csr(sym)
    np.testing.assert_array_equal(back.indices, sym.indices)


# ---------------------------------------------------------------------------
# the bool-plane baseline (packed=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["push", "pull", "paper", "beamer"])
def test_choose_mode_matches_reference_and_host_version(policy):
    """The device-side scheduler on fetched numpy scalars, as the
    bool-plane driver calls it, against the reference's and the host
    version, around both beamer thresholds."""
    from repro.core.scheduler import choose_mode as j_choose_mode
    from repro_torch.core import choose_mode, choose_mode_host
    rng = np.random.default_rng(0)
    cfg, jcfg = SchedulerConfig(policy=policy), JSched(policy=policy)
    n = 4096
    for _ in range(60):
        n_f, n_u = (np.int32(x) for x in rng.integers(0, n, 2))
        m_f = np.int32(rng.integers(0, 20000))
        m_u = np.int32(m_f * 14 + rng.integers(-2, 3))
        for prev in (0, 1):
            got = choose_mode(cfg, torch.tensor(prev, dtype=torch.int32),
                              n_f, m_f, m_u, n, n_u)
            want = j_choose_mode(jcfg, jnp.int32(prev), n_f, m_f, m_u, n,
                                 n_u)
            assert got.dtype == torch.int32
            assert int(got) == int(want) == choose_mode_host(
                cfg, prev, int(n_f), int(m_f), int(m_u), n, int(n_u))


@pytest.mark.parametrize("policy", ["push", "pull", "beamer"])
@pytest.mark.parametrize("batch", [1, 32, 48])
def test_boolplane_matches_reference(batch, policy):
    """Against the reference's bool-plane baseline with its P3 kernel in
    interpret mode: levels, every per-scalar fetch, last_stats and
    host_transfers; the packed runner gives the same levels."""
    src, dst = _awkward_edges(N, 400, seed=20 + batch)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(batch, seed=batch + 3)
    jr = JMS(jg, JSched(policy=policy), use_pallas=True, packed=False)
    for use_kernels in (False, True):
        tr = MultiSourceBFSRunner(tg, SchedulerConfig(policy=policy),
                                  use_kernels=use_kernels, packed=False)
        jres, tres = _same_run(jr, tr, roots)
        assert tres.host_transfers == jres.host_transfers
        assert "traversed_per_plane" not in tr.last_stats
    packed = MultiSourceBFSRunner(tg, use_kernels=False).run(roots)
    np.testing.assert_array_equal(packed.levels, tres.levels)
    for i, r in enumerate(roots[:4]):
        np.testing.assert_array_equal(tres.levels[i].astype(np.int64),
                                      bfs_oracle(tc, int(r)))


def test_boolplane_kernel_route_on_cpu():
    """use_kernels=True reaches K3's rows form on the engine's [n_pad, nw]
    words as they are, contiguous and untransposed (its plain body on the
    CPU, so no launch is counted), and gives the levels of
    use_kernels=False and of the reference's Pallas bool-plane run."""
    src, dst = _awkward_edges(N, 400, seed=4)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(40, seed=4)
    calls = []
    orig = kbu.bitmap_update_rows

    def spy(cand, visited):
        calls.append((tuple(cand.shape), cand.is_contiguous(),
                      visited.is_contiguous()))
        return orig(cand, visited)

    kbu.reset_launches()
    mp = pytest.MonkeyPatch()
    try:
        from repro_torch.kernels import ops
        mp.setattr(ops, "bitmap_update_rows", spy)
        got = MultiSourceBFSRunner(tg, use_kernels=True,
                                   packed=False).run(roots)
    finally:
        mp.undo()
    want = MultiSourceBFSRunner(tg, use_kernels=False,
                                packed=False).run(roots)
    np.testing.assert_array_equal(got.levels, want.levels)
    jres = JMS(jg, use_pallas=True, packed=False).run(roots)
    np.testing.assert_array_equal(got.levels, np.asarray(jres.levels))
    assert calls and all(c == ((tg.n_pad, 2), True, True) for c in calls)
    assert kbu.LAUNCHES["bitmap_update_batch"] == 0


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def _far_vertex(csr, root: int) -> int:
    """A vertex at level >= 3 (or unreached) from ``root``: XOR-ing its
    plane bit at level 1 plants a spurious discovery."""
    lv = bfs_oracle(csr, root)
    return int(np.flatnonzero((lv >= 3) | (lv == INF))[0])


@pytest.mark.parametrize("program", ["bfs", "cc", "sssp"])
@pytest.mark.parametrize("mode", ["invariants", "witness", "audit"])
def test_integrity_statvecs_and_witness_match_reference(mode, program):
    src, dst = _awkward_edges(N, 400, seed=30)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(48, seed=6)
    j_cls = {"bfs": JMS, "cc": JCC, "sssp": JSSSP}[program]
    t_cls = {"bfs": MultiSourceBFSRunner, "cc": ConnectedComponentsRunner,
             "sssp": SSSPRunner}[program]
    kw = dict(integrity=mode, witness_k=16, integrity_seed=11)
    jr, tr = j_cls(jg, use_pallas=False, **kw), t_cls(tg, use_kernels=False,
                                                       **kw)
    j_fetch, t_fetch = _recording(jr), _recording(tr)
    for _ in range(2):              # the witness stream advances per wave
        jres, tres = jr.run(roots), tr.run(roots)
        np.testing.assert_array_equal(tres.levels, jres.levels)
        assert _stats(tr) == _stats(jr)
    # the reference fetches its final rows with _fetch_many, the port
    # through _fetch: compare the statvecs
    svs = [a for a in t_fetch if a.shape == (8,)]
    j_svs = [a for a in j_fetch if a.shape == (8,)]
    assert len(svs) == len(j_svs) > 0
    for a, b in zip(svs, j_svs):
        np.testing.assert_array_equal(a, b)
    assert all(int(sv[tvp.SV_CHECK]) == 0 for sv in svs)
    assert tres.host_transfers == tres.iterations + 2
    st = tr.last_stats["integrity"]
    assert st["mode"] == mode
    assert st["witness_sampled"] == (0 if mode == "invariants" else 16)


def test_witness_check_matches_reference_on_clean_and_corrupt_values():
    src, dst = _awkward_edges(N, 400, seed=31)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(40, seed=7)
    rows = MultiSourceBFSRunner(tg, use_kernels=False).run(roots).levels
    value = np.full((tg.n_pad, roots.size), INF, np.int32)
    value[:N] = rows.T
    bad = value.copy()
    reached = np.argwhere((value > 0) & (value < INF))
    for v, p in reached[:5]:
        bad[v, p] += 2                        # no parent at value - 1
    sample = np.random.default_rng(0).integers(0, N, 64).astype(np.int32)
    sample[:5] = reached[:5, 0]
    for vals, budget in ((value, 4096), (bad, 4096), (bad, 8)):
        got = tvp._witness_check(tg, torch.from_numpy(vals),
                                 torch.from_numpy(sample), budget).numpy()
        want = np.asarray(jvp._witness_check(jg, jnp.asarray(vals),
                                             jnp.asarray(sample), budget))
        np.testing.assert_array_equal(got, want)
    assert tuple(got) == (got[0], 1)          # budget 8 truncates
    clean = tvp._witness_check(tg, torch.from_numpy(value),
                               torch.from_numpy(sample), 4096).numpy()
    assert tuple(clean) == (0, 0)


@pytest.mark.parametrize("plane", [0, 31, 47])
def test_xor_plane_bit_matches_reference(plane):
    words = np.random.default_rng(plane).integers(0, 2**32, (N, 2),
                                                  dtype=np.uint32)
    got = tvp._xor_plane_bit(planes_from_numpy(words, "cpu"), 5, plane)
    want = jvp._xor_plane_bit(jnp.asarray(words), 5, plane)
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["invariants", "witness"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_injected_flip_raises_in_both(mode, use_kernels):
    src, dst = _awkward_edges(N, 400, seed=32)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(48, seed=8)
    roots[0] = 3
    flip = (1, _far_vertex(tc, 3), 0)
    jr = JMS(jg, use_pallas=False, integrity=mode)
    tr = MultiSourceBFSRunner(tg, use_kernels=use_kernels, integrity=mode)
    jr._corrupt_plane = tr._corrupt_plane = flip
    with pytest.raises(JIntegrityError):
        jr.run(roots)
    with pytest.raises(IntegrityError):
        tr.run(roots)
    assert tr._corrupt_plane is None          # exact-once: hook consumed
    np.testing.assert_array_equal(tr.run(roots).levels,
                                  jr.run(roots).levels)


@pytest.mark.parametrize("step", ["vp_push_step", "vp_pull_step"])
def test_checked_state_carried_across(step):
    """The reference's checked init state (plane words, value rows and its
    int32[8] statvec), carried into the port through ``interop``, gives
    the reference's next checked step, statvec residue included; a flipped
    frontier bit shows in the residue slot of both."""
    src, dst = _awkward_edges(N, 400, seed=33)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(40, seed=12)
    jf, js, jv, jsv = jvp.vp_init_state(jg, jnp.asarray(roots), jvp.BFS,
                                        check=True)
    tf, ts, tv, tsv = tvp.vp_init_state(tg, torch.from_numpy(roots),
                                        tvp.BFS, check=True)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    assert tsv.shape == (8,)
    jf = jvp._xor_plane_bit(jf, _far_vertex(tc, int(roots[2])), 2)
    carried = (planes_from_numpy(np.asarray(jf), "cpu"),
               planes_from_numpy(np.asarray(js), "cpu"),
               torch.from_numpy(np.array(jv)))
    want = getattr(jvp, step)(jg, jf, js, jv, np.int32(0), jvp.BFS, 1 << 12,
                              check=True)
    got = getattr(tvp, step)(tg, *carried, 0, tvp.BFS, 1 << 12, check=True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(planes_to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3][tvp.SV_CHECK]) > 0


def test_integrity_mode_validated():
    *_, tg = _graphs(*_awkward_edges(N, 50, seed=1))
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(tg, integrity="paranoid")


# ---------------------------------------------------------------------------
# overflow control
# ---------------------------------------------------------------------------

def _understating(runner):
    """The runner reads m_f = m_u = 1 from every statvec, so its budget
    stays too small and each wide level overflows."""
    fetch = runner._fetch

    def spy(arr):
        out = np.array(fetch(arr))
        if out.shape in ((7,), (8,)):
            out[[tbl.SV_MF, tbl.SV_MU]] = 1
        return out

    runner._fetch = spy


def _understated_iter_stats(mod, monkeypatch):
    """The bool-plane driver's four stats with m_f = m_u = 1."""
    orig = mod._ms_iter_stats

    def stats(g, frontier, seen):
        n_f, _, _, n_u = orig(g, frontier, seen)
        return n_f, n_f * 0 + 1, n_f * 0 + 1, n_u

    monkeypatch.setattr(mod, "_ms_iter_stats", stats)


@pytest.mark.parametrize("packed", [True, False])
def test_budget_overflow_error_and_retries(packed, monkeypatch):
    src, dst = _awkward_edges(N, 600, seed=40)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(32, seed=9)
    if not packed:
        _understated_iter_stats(jvp, monkeypatch)
        _understated_iter_stats(tvp, monkeypatch)

    def pair(retries):
        jr = JMS(jg, JSched(policy="push"), init_budget=4, use_pallas=False,
                 packed=packed, max_overflow_retries=retries)
        tr = MultiSourceBFSRunner(tg, SchedulerConfig(policy="push"),
                                  init_budget=4, use_kernels=False,
                                  packed=packed, max_overflow_retries=retries)
        if packed:
            _understating(jr)
            _understating(tr)
        return jr, tr

    jr, tr = pair(1)
    with pytest.raises(JBudgetOverflowError) as je:
        jr.run(roots)
    with pytest.raises(BudgetOverflowError) as te:
        tr.run(roots)
    assert ((te.value.budget, te.value.need, te.value.retries)
            == (je.value.budget, je.value.need, je.value.retries))
    jr, tr = pair(None)
    jres, tres = _same_run(jr, tr, roots)
    assert tres.overflow_retries == jres.overflow_retries > 0
    assert tres.host_transfers == jres.host_transfers


@pytest.mark.parametrize("packed", [True, False])
def test_per_wave_budget_override(packed):
    src, dst = _awkward_edges(N, 600, seed=41)
    jc, jg, tc, tg = _graphs(src, dst)
    roots = _roots(32, seed=10)
    jr = JMS(jg, init_budget=4, use_pallas=False, packed=packed)
    tr = MultiSourceBFSRunner(tg, init_budget=4, use_kernels=False,
                              packed=packed)
    _same_run(jr, tr, roots, budget=64)
    assert tr.last_stats["budget"] >= 64
    _same_run(jr, tr, roots)                  # the override was per wave
    np.testing.assert_array_equal(tr.run_batch(roots, budget=1 << 12),
                                  jr.run_batch(roots, budget=1 << 12))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["cc", "sssp"])
def test_build_engine_serves_cc_and_sssp(algo, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    roots = np.asarray([0, 5, 5, 100, 4095, 17, 2048])
    engine, deg = serve.build_engine("small-12-8", algo=algo, device="cpu")
    assert engine.g.device.type == "cpu"
    got = serve.bfs_batch(roots, engine=engine, out_deg=deg, algo=algo)
    want = jserve.bfs_batch(roots, graph="small-12-8", algo=algo)
    np.testing.assert_array_equal(got["levels"], want["levels"])
    for k in ("iterations", "push_iters", "pull_iters", "edges_inspected",
              "traversed_edges", "host_transfers", "algo", "batch"):
        assert got[k] == want[k], k
    if algo == "cc":
        assert got["components"] == want["components"]
    out = serve.serve_bfs("small-12-8", 8, algo=algo, device="cpu",
                          sparse_pull=True)
    assert out["algo"] == algo
    assert out["host_transfers"] == out["iterations"] + 2
