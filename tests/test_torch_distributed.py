"""The port's distributed engine (``repro_torch.core.bfs_distributed``)
against the reference's (``repro.core.bfs_distributed``).

One rank: a one-rank gloo group made by a fixture in this process, beside
the reference on a one-device mesh, both on the same graphs.  Many ranks:
eight gloo ranks (``test_torch_dispatcher.run_ranks``) against the
reference on eight host devices in a subprocess.  The comparison is
exact: equal level rows (int64) and equal ``last_stats``.  The reference's
batched pull with ``use_pallas=True`` fails to trace on the installed JAX,
so the port's kernel path is held against the reference's jnp path.
"""
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch.distributed as dist                           # noqa: E402

from repro.compat import make_mesh as j_make_mesh          # noqa: E402
from repro.core import CC as J_CC                          # noqa: E402
from repro.core import SSSP as J_SSSP                      # noqa: E402
from repro.core import VertexProgram as JVertexProgram     # noqa: E402
from repro.core import bfs_oracle                          # noqa: E402
from repro.core import partition_graph as j_partition      # noqa: E402
from repro.core.bfs_distributed import DistConfig as JConfig  # noqa: E402
from repro.core.bfs_distributed import DistributedBFS as JEngine  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import get_dataset as j_get_dataset       # noqa: E402
from repro.graph import symmetrize_csr as j_symmetrize     # noqa: E402
from repro.graph import transpose_csr as j_transpose       # noqa: E402
from repro_torch.core import CC, SSSP, VertexProgram       # noqa: E402
from repro_torch.core import partition_graph               # noqa: E402
from repro_torch.core.bfs_distributed import (DistConfig,  # noqa: E402
                                              DistributedBFS,
                                              pull_tile_rows)
from repro_torch.core.scheduler import SchedulerConfig     # noqa: E402
from repro_torch.graph import (csr_from_edges, get_dataset,  # noqa: E402
                               symmetrize_csr, transpose_csr)
from repro_torch.kernels import msbfs_propagate as kmod    # noqa: E402
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.launch.mesh import make_mesh              # noqa: E402
from test_torch_dispatcher import run_ranks, run_reference  # noqa: E402


@pytest.fixture
def graph_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path / "graphs"))
    return tmp_path


@pytest.fixture
def mesh(tmp_path):
    """A one-rank gloo group and its ("data",) mesh, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()


def _ref_mesh():
    return j_make_mesh((1,), ("data",))


def _assert_same(got, want, eng, ref):
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert eng.last_stats == ref.last_stats


def _random_pair(shards: int = 4, seed: int = 3, symmetric: bool = False):
    """The reference tests' 64-vertex random graph, both packages."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 64, 256), rng.integers(0, 64, 256)
    csr, jcsr = csr_from_edges(src, dst, 64), j_csr_from_edges(src, dst, 64)
    if symmetric:
        csr, jcsr = symmetrize_csr(csr), j_symmetrize(jcsr)
    return (jcsr, partition_graph(csr, transpose_csr(csr), shards),
            j_partition(jcsr, j_transpose(jcsr), shards))


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["bitmap", "queue"])
@pytest.mark.parametrize("scheme", ["hash", "contiguous"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("graph", ["tiny-16-4", "small-12-8"])
def test_one_rank_matches_reference(graph_cache, mesh, graph, k, scheme,
                                    dispatch):
    ds, jds = get_dataset(graph), j_get_dataset(graph)
    deg = np.diff(ds.csr.indptr)
    roots = np.random.default_rng(k).choice(np.flatnonzero(deg > 0), 5,
                                            replace=False)
    # 16-slot FIFOs overflow on small-12-8: the queue drain rounds run
    kw = dict(dispatch=dispatch, queue_capacity=16)
    eng = DistributedBFS(partition_graph(ds.csr, ds.csc, k, scheme=scheme),
                         mesh, cfg=DistConfig(**kw))
    ref = JEngine(j_partition(jds.csr, jds.csc, k, scheme=scheme),
                  _ref_mesh(), cfg=JConfig(**kw))
    assert eng.num_vertices == ref.num_vertices
    np.testing.assert_array_equal(eng.out_deg, ref.out_deg)
    got, want = eng.run(int(roots[0])), ref.run(int(roots[0]))
    _assert_same(got, want, eng, ref)
    np.testing.assert_array_equal(got, bfs_oracle(ds.csr, int(roots[0])))
    if dispatch == "queue":
        for e in (eng, ref):
            with pytest.raises(NotImplementedError, match="bitmap dispatch"):
                e.run_batch(roots)
        return
    got_b, want_b = eng.run_batch(roots), ref.run_batch(roots)
    _assert_same(got_b, want_b, eng, ref)
    np.testing.assert_array_equal(got_b[0], got)


@pytest.mark.parametrize("policy", ["push", "pull", "paper"])
def test_one_rank_forced_direction_matches_reference(mesh, policy):
    jcsr, pg, jpg = _random_pair()
    sched = dict(scheduler=SchedulerConfig(policy=policy))
    eng = DistributedBFS(pg, mesh, cfg=DistConfig(**sched))
    ref = JEngine(jpg, _ref_mesh(),
                  cfg=JConfig(scheduler=JSched(policy=policy)))
    roots = np.asarray([0, 2, 5, 31, 63])
    _assert_same(eng.run_batch(roots), ref.run_batch(roots), eng, ref)
    if policy != "paper":
        key = "pull_iters" if policy == "pull" else "push_iters"
        other = "push_iters" if policy == "pull" else "pull_iters"
        assert eng.last_stats[key] > 0 and eng.last_stats[other] == 0
    _assert_same(eng.run(5), ref.run(5), eng, ref)


def test_one_rank_two_plane_words_matches_reference(mesh):
    """48 concurrent sources = 2 packed plane words per vertex."""
    jcsr, pg, jpg = _random_pair()
    eng, ref = DistributedBFS(pg, mesh), JEngine(jpg, _ref_mesh())
    roots = np.random.default_rng(11).choice(64, 48, replace=False)
    got = eng.run_batch(roots)
    _assert_same(got, ref.run_batch(roots), eng, ref)
    assert got.shape == (48, 64)
    for i, r in enumerate(roots):
        np.testing.assert_array_equal(got[i], bfs_oracle(jcsr, int(r)))


def test_one_rank_cc_and_sssp_match_reference(mesh):
    jcsr, pg, jpg = _random_pair(symmetric=True)
    seeds = np.asarray([0, 5, 40, 63])
    eng = DistributedBFS(pg, mesh, program=CC)
    ref = JEngine(jpg, _ref_mesh(), program=J_CC)
    _assert_same(eng.run_batch(seeds), ref.run_batch(seeds), eng, ref)
    assert eng.last_stats["algo"] == "cc"
    jcsr, pg, jpg = _random_pair()
    eng = DistributedBFS(pg, mesh, program=SSSP)
    ref = JEngine(jpg, _ref_mesh(), program=J_SSSP)
    roots = np.asarray([0, 2, 31, 63])
    _assert_same(eng.run_batch(roots), ref.run_batch(roots), eng, ref)
    assert eng.last_stats["algo"] == "sssp"


def test_one_rank_rejects_what_the_reference_rejects(mesh):
    """A payload (max) combine cannot ride the OR crossbar, and a root
    out of range is refused, in both packages alike."""
    _, pg, jpg = _random_pair()
    eng, ref = DistributedBFS(pg, mesh), JEngine(jpg, _ref_mesh())
    for e, vp in ((eng, VertexProgram(name="payload-max", combine="max")),
                  (ref, JVertexProgram(name="payload-max", combine="max"))):
        with pytest.raises(NotImplementedError, match="OR-reduce-scatter"):
            e.run_program_batch(vp, np.asarray([0, 1]))
        with pytest.raises(ValueError, match="out of range"):
            e.run_batch(np.asarray([0, 64]))


def _spy_msgs(monkeypatch) -> list:
    """Record the tile of every ``ops.msbfs_propagate_msgs`` call."""
    tiles = []
    real = ops.msbfs_propagate_msgs

    def spy(*a, **kw):
        tiles.append(kw["tile_rows"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "msbfs_propagate_msgs", spy)
    return tiles


@pytest.mark.parametrize("policy", ["beamer", "pull"])
def test_kernel_path_on_cpu_equals_plain_path(graph_cache, mesh,
                                              monkeypatch, policy):
    """``use_kernels=True`` on the CPU (K2's wrapper with its plain body)
    gives the plain path's rows and stats, and every pull level goes
    through the msgs form at the PE interval."""
    ds = get_dataset("small-12-8")
    pg = partition_graph(ds.csr, ds.csc, 4)
    sched = SchedulerConfig(policy=policy)
    roots = np.asarray([7, 100, 2000, 4095, 7])
    plain = DistributedBFS(pg, mesh, cfg=DistConfig(use_kernels=False,
                                                    scheduler=sched))
    want = plain.run_batch(roots)
    tiles = _spy_msgs(monkeypatch)
    kern = DistributedBFS(pg, mesh, cfg=DistConfig(use_kernels=True,
                                                   scheduler=sched))
    got = kern.run_batch(roots)
    _assert_same(got, want, kern, plain)
    assert len(tiles) >= kern.last_stats["pull_iters"] > 0
    assert set(tiles) == {pg.verts_per_shard}
    assert DistributedBFS(pg, mesh).use_kernels is False    # CPU: plain


def test_pull_tile_rule():
    """The tile is the PE interval when its accumulator fits one block,
    else the largest multiple of 8 dividing it that fits; a batch too wide
    for 8 rows raises; a given tile is kept."""
    smem = kmod.MAX_SMEM_PER_BLOCK
    assert pull_tile_rows(16384, 2) == 16384          # rmat20-16, Q=64, B=64
    assert 16384 * 2 * 4 <= smem
    assert pull_tile_rows(16384, 4) == 8192           # B = 128 does not fit
    assert pull_tile_rows(70016, 1) == 35008          # 70016 = 2**7 * 547
    assert pull_tile_rows(8192, 1, tile_rows=256) == 256
    for vl, nw in ((16384, 4), (70016, 1), (32768, 8)):
        t = pull_tile_rows(vl, nw)
        assert t % 8 == 0 and vl % t == 0 and t * nw * 4 <= smem
        assert not any(vl % u == 0 for u in range(t + 8, smem // (4 * nw)
                                                   + 1, 8))
    with pytest.raises(ValueError, match="no tile"):
        pull_tile_rows(1024, smem // 28)                  # 7 rows fit


def test_tile_rule_on_the_engine(graph_cache, mesh, monkeypatch):
    """A PE interval too large for one tile: the engine tiles at the rule's
    smaller tile, with rows equal to the reference's; when no tile fits,
    the run raises."""
    ds, jds = get_dataset("small-12-8"), j_get_dataset("small-12-8")
    pg = partition_graph(ds.csr, ds.csc, 2)                 # vl = 2048
    roots = np.asarray([7, 100, 2000])
    ref = JEngine(j_partition(jds.csr, jds.csc, 2), _ref_mesh(),
                  cfg=JConfig(scheduler=JSched(policy="pull")))
    want = ref.run_batch(roots)
    monkeypatch.setattr(kmod, "MAX_SMEM_PER_BLOCK", 4000)   # 1000 rows fit
    tiles = _spy_msgs(monkeypatch)
    eng = DistributedBFS(pg, mesh, cfg=DistConfig(
        use_kernels=True, scheduler=SchedulerConfig(policy="pull")))
    _assert_same(eng.run_batch(roots), want, eng, ref)
    assert set(tiles) == {512}
    monkeypatch.setattr(kmod, "MAX_SMEM_PER_BLOCK", 16)     # 4 rows fit
    with pytest.raises(ValueError, match="no tile"):
        eng.run_batch(roots)


def test_config_and_mesh_errors(tmp_path):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("data",), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="2 ranks"):
            make_mesh((2,), ("data",), device="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            make_mesh((1,), ("data", "model"), device="cpu")
        _, pg, jpg = _random_pair(shards=3)
        mesh2 = make_mesh((1, 1), ("data", "model"), device="cpu")
        eng = DistributedBFS(pg, mesh2)
        ref = JEngine(jpg, j_make_mesh((1, 1), ("data", "model")))
        assert (eng.d, eng.k, eng.q) == (1, 3, 3)
        _assert_same(eng.run_batch(np.asarray([0, 5])),
                     ref.run_batch(np.asarray([0, 5])), eng, ref)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# many ranks: the reference's grids (tests/test_distributed_bfs.py)
# ---------------------------------------------------------------------------

ROOT_V = 7
BATCH_ROOTS = [7, 100, 2000, 4095]

_PORT_GRID = """
import json
from repro_torch.core import partition_graph
from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
from repro_torch.graph import get_dataset
from repro_torch.launch.mesh import make_mesh

ds = get_dataset("small-12-8")
mesh = make_mesh(SHAPE, NAMES, device="cpu")
levels, stats = {}, {}
for key, q, scheme, kw, axes in CASES:
    pg = partition_graph(ds.csr, ds.csc, q, scheme=scheme)
    eng = DistributedBFS(pg, mesh, axis_names=axes, cfg=DistConfig(**kw))
    levels[key], stats[key] = eng.run(ROOT_V), eng.last_stats
    if kw["dispatch"] == "bitmap":
        levels[key + "/batch"] = eng.run_batch(np.asarray(BATCH_ROOTS))
        stats[key + "/batch"] = eng.last_stats
np.savez(f"{tmp}/rank{rank}.npz", **levels)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(stats, f)
"""

_REFERENCE_GRID = """
import json, sys
import numpy as np
from repro.compat import make_mesh
from repro.core import partition_graph
from repro.core.bfs_distributed import DistConfig, DistributedBFS
from repro.graph import get_dataset

ds = get_dataset("small-12-8")
mesh = make_mesh(SHAPE, NAMES)
levels, stats = {}, {}
for key, q, scheme, kw, axes in CASES:
    pg = partition_graph(ds.csr, ds.csc, q, scheme=scheme)
    eng = DistributedBFS(pg, mesh, axis_names=axes, cfg=DistConfig(**kw))
    levels[key], stats[key] = eng.run(ROOT_V), eng.last_stats
    if kw["dispatch"] == "bitmap":
        levels[key + "/batch"] = eng.run_batch(np.asarray(BATCH_ROOTS))
        stats[key + "/batch"] = eng.last_stats
np.savez(sys.argv[1] + "/ref.npz", **levels)
with open(sys.argv[1] + "/ref.json", "w") as f:
    json.dump(stats, f)
"""


def _run_grid(tmp_path, shape, names, cases):
    get_dataset("small-12-8")                      # cached before the ranks
    world = int(np.prod(shape))
    head = (f"SHAPE, NAMES, CASES = {shape!r}, {names!r}, {cases!r}\n"
            f"ROOT_V, BATCH_ROOTS = {ROOT_V}, {BATCH_ROOTS!r}\n")
    run_reference(head + _REFERENCE_GRID, world, str(tmp_path))
    run_ranks(head + _PORT_GRID, world, tmp_path)
    want = np.load(tmp_path / "ref.npz")
    want_stats = json.loads((tmp_path / "ref.json").read_text())
    oracle = {r: bfs_oracle(j_get_dataset("small-12-8").csr, r)
              for r in {ROOT_V, *BATCH_ROOTS}}
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        stats = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            rows = np.atleast_2d(got[key])
            roots = BATCH_ROOTS if key.endswith("/batch") else [ROOT_V]
            for row, root in zip(rows, roots):
                np.testing.assert_array_equal(row, oracle[root],
                                              err_msg=f"rank {r} {key}")
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"rank {r} {key}")
            assert stats[key] == want_stats[key], (r, key)


@pytest.mark.slow
def test_eight_ranks_dispatch_modes(graph_cache):
    """Mesh (2, 2, 2), 8 shards: bitmap staged / flat and queue flat; then
    the shards over ("data", "model") only, replicated over "pod"."""
    cases = [(f"{d}-{x}", 8, "hash",
              dict(dispatch=d, crossbar=x, queue_capacity=256), None)
             for d, x in (("bitmap", "staged"), ("bitmap", "flat"),
                          ("queue", "flat"))]
    cases += [(f"data-model-{d}-{x}", 4, "hash",
               dict(dispatch=d, crossbar=x, queue_capacity=256),
               ("data", "model"))
              for d, x in (("bitmap", "staged"), ("queue", "flat"))]
    _run_grid(graph_cache, (2, 2, 2), ("pod", "data", "model"), cases)


@pytest.mark.slow
def test_eight_ranks_pes_per_pc_and_schemes(graph_cache):
    """Mesh (4, 2): k = 1, 2, 4 PEs per rank x hash / contiguous x bitmap /
    queue (Fig. 10's scaling direction)."""
    cases = [(f"k{k}-{s}-{d}", 8 * k, s, dict(dispatch=d, queue_capacity=512),
              None)
             for k in (1, 2, 4) for s in ("hash", "contiguous")
             for d in ("bitmap", "queue")]
    _run_grid(graph_cache, (4, 2), ("data", "model"), cases)
