"""The port's batched MS-BFS engine against the reference engine.

The same graphs (isolated vertices, self-loops) and roots go through
``repro.core.MultiSourceBFSRunner(use_pallas=False)`` and the port's
runner on the CPU.  The plain port path must reproduce the reference's
levels, per-level statvec sequence and ``last_stats`` exactly; the kernel
path (``use_kernels=True``, the wrappers' plain bodies on the CPU) must
reproduce the levels and the scheduler slots of every statvec.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402
import torch                                               # noqa: E402

from repro.core import MultiSourceBFSRunner as JRunner     # noqa: E402
from repro.core import SchedulerConfig as JSched           # noqa: E402
from repro.core import bfs_local as jbl                    # noqa: E402
from repro.core import msbfs_reference as j_msbfs_reference  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import get_dataset as j_get_dataset       # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro_torch.core import (MultiSourceBFSRunner, SchedulerConfig,  # noqa: E402
                              bfs_oracle, build_local_graph,
                              compact_indices, expand_edges, get_program,
                              msbfs_reference)
from repro_torch.core import bfs_local as tbl              # noqa: E402
from repro_torch.core.scheduler import PUSH, choose_mode_host  # noqa: E402
from repro_torch.graph import csr_from_edges, get_dataset, transpose_csr  # noqa: E402
from repro_torch.interop import local_graph_from_numpy     # noqa: E402

N = 128
SV_SCHED = [tbl.SV_NF, tbl.SV_MF, tbl.SV_MU, tbl.SV_NU, tbl.SV_COUNT]


def _awkward_edges(n: int, m: int, seed: int):
    """Edges confined to the first 3n/4 vertices (the last quarter is
    isolated), plus a self-loop on every 16th active vertex."""
    rng = np.random.default_rng(seed)
    hi = (3 * n) // 4
    loops = np.arange(0, hi, 16)
    src = np.concatenate([rng.integers(0, hi, m), loops])
    dst = np.concatenate([rng.integers(0, hi, m), loops])
    return src, dst


def _graphs(src, dst, n):
    """(reference csr, reference LocalGraph, port csr, port LocalGraph)."""
    jc = j_csr_from_edges(src, dst, n)
    tc = csr_from_edges(src, dst, n)
    return (jc, jbl.build_local_graph(jc, j_transpose_csr(jc)), tc,
            build_local_graph(tc, transpose_csr(tc), device="cpu"))


def _roots(n: int, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    roots = rng.choice(n, batch, replace=False)
    if batch >= 2:
        roots[0] = n - 1        # isolated
        roots[1] = 16           # self-loop vertex
    return roots.astype(np.int32)


def _recording(runner):
    """Record what the runner fetches through ``_fetch``: the statvecs,
    then (port only; the reference fetches them with ``_fetch_pair``)
    the final rows."""
    seen = []
    fetch = runner._fetch

    def spy(arr):
        out = fetch(arr)
        seen.append(np.asarray(out))
        return out

    runner._fetch = spy
    return seen


def _modes(svs, sched, n):
    """Direction of each level, replayed from the fetched statvecs."""
    mode, modes = PUSH, []
    for sv in svs[:-1]:
        mode = choose_mode_host(sched, mode, int(sv[0]), int(sv[1]),
                                int(sv[2]), n, int(sv[3]))
        modes.append(mode)
    return modes


_JREF = {}


def _jax_reference_levels(key, jg, roots):
    if key not in _JREF:
        _JREF[key] = np.asarray(j_msbfs_reference(jg, jnp.asarray(roots)))
    return _JREF[key]


@pytest.mark.parametrize("policy", ["push", "pull", "beamer"])
@pytest.mark.parametrize("batch", [1, 5, 31, 33, 48])
def test_engine_matches_reference_engine(batch, policy):
    src, dst = _awkward_edges(N, 512, seed=100 + batch)
    jc, jg, tc, tg = _graphs(src, dst, N)
    roots = _roots(N, batch, seed=batch)
    jr = JRunner(jg, JSched(policy=policy), use_pallas=False)
    j_svs = _recording(jr)
    jres = jr.run(roots)
    sched = SchedulerConfig(policy=policy)

    # plain path: everything equal
    tr = MultiSourceBFSRunner(tg, sched, use_kernels=False)
    t_svs = _recording(tr)
    tres = tr.run(roots)
    np.testing.assert_array_equal(tres.levels, jres.levels)
    assert len(t_svs) == len(j_svs) + 1
    for a, b in zip(t_svs, j_svs):                     # the statvecs
        np.testing.assert_array_equal(a, b)
    want = {k: v for k, v in jr.last_stats.items() if k != "seconds"}
    got = {k: v for k, v in tr.last_stats.items()
           if k not in ("seconds", "budget_slots")}     # the port's own
    assert got == want
    assert tres.host_transfers == tres.iterations + 2
    assert len(tr.last_level_seconds) == tres.iterations

    # kernel path (the kernel wrappers' plain bodies on the CPU)
    kr = MultiSourceBFSRunner(tg, sched, use_kernels=True)
    k_svs = _recording(kr)
    kres = kr.run(roots)
    np.testing.assert_array_equal(kres.levels, jres.levels)
    assert len(k_svs) == len(j_svs) + 1
    for a, b in zip(k_svs, j_svs):
        np.testing.assert_array_equal(a[SV_SCHED], b[SV_SCHED])
    # each level inspects exactly its frontier's out-edges (push) or its
    # unseen vertices' in-edges (pull): what use_pallas=True would count
    modes = _modes(j_svs, sched, N)
    need = [int(sv[tbl.SV_MF] if m == PUSH else sv[tbl.SV_MU])
            for sv, m in zip(j_svs, modes)]
    assert kres.edges_inspected == sum(need)
    # every level expanded a budget at least its need: the written slots
    # hold every inspected edge
    assert kr.last_stats["budget_slots"] >= kres.edges_inspected
    assert kres.host_transfers == kres.iterations + 2
    assert kres.iterations == jres.iterations
    assert (kres.push_iters, kres.pull_iters) == (jres.push_iters,
                                                  jres.pull_iters)

    # the dense references and the pure-python oracle
    ref = msbfs_reference(tg, roots).numpy()
    np.testing.assert_array_equal(ref, tres.levels)
    np.testing.assert_array_equal(
        ref, _jax_reference_levels((batch, 100 + batch), jg, roots))
    for i, r in enumerate(roots):
        np.testing.assert_array_equal(tres.levels[i].astype(np.int64),
                                      bfs_oracle(tc, int(r)))


@pytest.mark.parametrize("tile_rows", [0, 16])
def test_kernel_path_forced_plans(tile_rows):
    """Whole-array and forced-tiled kernel plans give the same levels."""
    src, dst = _awkward_edges(N, 512, seed=7)
    jc, jg, tc, tg = _graphs(src, dst, N)
    roots = _roots(N, 40, seed=3)
    want = JRunner(jg, use_pallas=False).run(roots).levels
    got = MultiSourceBFSRunner(tg, use_kernels=True,
                               tile_rows=tile_rows).run(roots)
    np.testing.assert_array_equal(got.levels, want)


def test_sparse_pull_matches_reference(tmp_path, monkeypatch):
    """sparse_pull=True on a graph big enough for tail levels to take the
    budgeted pull: statvecs and last_stats equal the reference's."""
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    jds, tds = j_get_dataset("small-12-8"), get_dataset("small-12-8")
    jg = jbl.build_local_graph(jds.csr, jds.csc)
    tg = build_local_graph(tds.csr, tds.csc, device="cpu")
    deg = np.diff(tds.csr.indptr)
    # non-isolated roots: an isolated root's plane keeps every vertex
    # "unseen by some plane", so m_u never shrinks
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 40,
                                            replace=False)
    jr = JRunner(jg, JSched(policy="pull"), use_pallas=False,
                 sparse_pull=True)
    j_svs = _recording(jr)
    jres = jr.run(roots)
    tr = MultiSourceBFSRunner(tg, SchedulerConfig(policy="pull"),
                              use_kernels=False, sparse_pull=True)
    t_svs = _recording(tr)
    tres = tr.run(roots)
    np.testing.assert_array_equal(tres.levels, jres.levels)
    assert len(t_svs) == len(j_svs) + 1
    for a, b in zip(t_svs, j_svs):
        np.testing.assert_array_equal(a, b)
    assert ({k: v for k, v in tr.last_stats.items()
             if k not in ("seconds", "budget_slots")}
            == {k: v for k, v in jr.last_stats.items() if k != "seconds"})
    e_in = int(tg.in_indices.shape[0])
    assert any(int(sv[tbl.SV_TOTAL]) != e_in for sv in t_svs[1:-1]), \
        "no level took the sparse pull"


def test_interop_local_graph_round_trip():
    src, dst = _awkward_edges(N, 300, seed=11)
    jc, jg, tc, tg = _graphs(src, dst, N)
    fields = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name not in ("n", "n_pad")}
    carried = local_graph_from_numpy(fields, jg.n, jg.n_pad, device="cpu")
    assert (carried.n, carried.n_pad) == (tg.n, tg.n_pad)
    for k in tbl.FIELDS:
        a, b = getattr(carried, k), getattr(tg, k)
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        local_graph_from_numpy({}, 1, 32, device="cpu")


@pytest.mark.parametrize("cap", [64, 20])
def test_compact_and_expand_match_reference(cap):
    """P1/P2 primitives against the reference, truncation and overflow
    (total > budget) included."""
    rng = np.random.default_rng(cap)
    mask = rng.random(64) < 0.4
    gi, gc = compact_indices(torch.from_numpy(mask), cap)
    wi, wc = jax.jit(jbl.compact_indices, static_argnums=1)(
        jnp.asarray(mask), cap)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert int(gc) == int(wc)
    src, dst = _awkward_edges(64, 400, seed=cap)
    jc, jg, tc, tg = _graphs(src, dst, 64)
    for budget in (8, 256, 1024):
        got = expand_edges(gi, tg.out_indptr, tg.out_indices, budget)
        want = jax.jit(jbl.expand_edges, static_argnums=3)(
            wi, jg.out_indptr, jg.out_indices, budget)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_options_raise():
    """The options an earlier slice left unported now run; what stays
    refused is what the reference refuses too (ValueError)."""
    src, dst = _awkward_edges(N, 100, seed=1)
    *_, tg = _graphs(src, dst, N)
    base = MultiSourceBFSRunner(tg).run(np.asarray([0, 7]))
    bool_plane = MultiSourceBFSRunner(tg, packed=False).run(
        np.asarray([0, 7]))
    np.testing.assert_array_equal(bool_plane.levels, base.levels)
    witness = MultiSourceBFSRunner(tg, integrity="witness")
    np.testing.assert_array_equal(witness.run(np.asarray([0, 7])).levels,
                                  base.levels)
    assert witness.last_stats["integrity"]["mode"] == "witness"
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(tg, integrity="paranoid")
    with pytest.raises(ValueError):
        get_program("pagerank")
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(tg, use_kernels=False).run(np.asarray([N]))
    with pytest.raises(ValueError):
        MultiSourceBFSRunner(tg).run(np.asarray([0.5]))
    runner = MultiSourceBFSRunner(tg, use_kernels=False)
    assert runner.use_kernels is False
    assert MultiSourceBFSRunner(tg).use_kernels is False   # graph on CPU
    res = runner.run(np.asarray([3, 3, 5]))                # duplicates ok
    np.testing.assert_array_equal(res.levels[0], res.levels[1])
