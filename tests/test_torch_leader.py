"""The distributed engine served by its leader (``repro_torch.core.
bfs_distributed``, ``repro_torch.launch.leader``), on gloo ranks on the
CPU.

Graphs are Graph500 Kronecker graphs made by the benchmark's generator
(``bfsbench/kron.py``) and answers are held to its plain PyTorch BFS
(``bfsbench/refbfs.py``); every rank builds the same graph from the seed
and partitions it itself (``partition_rank_shards``), so no rank is handed
another's shards.  Ranks start as ``test_torch_dispatcher.run_ranks``
starts them; ``start_group`` is run in a subprocess of its own.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.bfs_distributed import (EXCHANGE_KINDS, HEADER_ROOTS,
                                              DistConfig, DistributedBFS)
from repro_torch.core.partition import partition_graph, partition_rank_shards
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.graph import get_dataset
from repro_torch.launch.mesh import make_mesh
from test_torch_dispatcher import ROOT, _env, run_ranks

SPANS = {"init", "level", "step", "expand", "exchange", "commit", "statvec",
         "statvec_fetch", "readback", "gather"}

# Each rank builds the graph from the seed and keeps its own shards.
_GRAPH = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from bfsbench import kron, refbfs
from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
from repro_torch.core.partition import partition_rank_shards
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.launch.mesh import make_mesh

cfg = dict(scale={scale}, edge_factor=16, initiator=[0.57, 0.19, 0.19, 0.05],
           undirected=True)
csr, csc = kron.build_graph(cfg, {seed}, "cpu")
shards = partition_rank_shards(csr.indptr, csr.indices, csc.indptr,
                               csc.indices, {shards}, world)
mesh = make_mesh((world,), ("data",), device="cpu")
eng = DistributedBFS(shards[rank], mesh, cfg=DistConfig(
    scheduler=SchedulerConfig(policy={policy!r})))
del shards
"""

_WAVES = """
deg = (csr.indptr[1:] - csr.indptr[:-1]).numpy()
keys = np.flatnonzero(deg > 0)
rng = np.random.default_rng(5)
comp = kron.component_arcs(csr).numpy()
small = int(np.flatnonzero(comp == comp[comp > 0].min())[0])
alone = int(np.flatnonzero(deg == 0)[0])
waves = [rng.choice(keys, 32, replace=False),
         np.asarray([keys[3], keys[3], keys[9], small, keys[3], alone]),
         np.concatenate([rng.choice(keys, {wide} - 2), [small, small]])]
# every rank makes the same call (SPMD): the rows come back on rank 0
spmd = eng.run_batch(waves[0])
assert (spmd is None) == (rank != 0), rank
out = dict(rank=rank, small_arcs=int(comp[small]), alone=alone)
if rank == 0:
    bad = 0
    rows_checked = 0
    for roots in waves:
        rows = eng.run_batch(roots)
        assert rows.dtype == np.int32 and rows.shape == (roots.size, csr.n)
        for root, row in zip(roots, rows):
            bad += refbfs.mismatches(csr.indptr, csr.indices, int(root), row)
            rows_checked += 1
    bad += refbfs.mismatches(csr.indptr, csr.indices, small,
                             eng.run(small))
    bad += refbfs.mismatches(csr.indptr, csr.indices, int(waves[0][0]),
                             np.asarray(spmd[0]))
    eng.close()
    out.update(bad=bad, rows=rows_checked, calls=len(waves) + 1)
else:
    out["calls"] = eng.follow()
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
"""


def _graph_body(scale: int, seed: int, shards: int, policy: str) -> str:
    return _GRAPH.format(root=str(ROOT), scale=scale, seed=seed,
                         shards=shards, policy=policy)


def _rank_json(tmp_path, world: int) -> list:
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("policy", ["beamer", "pull"])
def test_leader_waves_on_four_ranks_equal_the_plain_bfs(tmp_path, policy):
    """Kronecker scale 11 on 4 ranks x 2 PEs: an SPMD wave (rows on rank 0
    only), then the leader's waves — distinct roots, duplicates, a root
    in the smallest component and an isolated one, more roots than the
    call header holds — and a single root, with the other ranks in
    ``follow()`` until ``close()``; every row equals the plain BFS."""
    body = _graph_body(11, 2**31 + 4, 8, policy) + _WAVES.replace(
        "{wide}", str(HEADER_ROOTS + 40))
    run_ranks(body, 4, tmp_path)
    ranks = _rank_json(tmp_path, 4)
    lead = ranks[0]
    assert lead["small_arcs"] == 2           # one edge apart from the rest
    assert lead["bad"] == 0 and lead["rows"] == 32 + 6 + HEADER_ROOTS + 40
    assert [r["calls"] for r in ranks[1:]] == [lead["calls"]] * 3


_COUNTS = """
from torch.profiler import ProfilerActivity, profile
roots = np.flatnonzero((csr.indptr[1:] - csr.indptr[:-1]).numpy())[:40]
with profile(activities=[ProfilerActivity.CPU]) as prof:
    if rank == 0:
        rows = eng.run_batch(roots)
        eng.close()
        assert rows.dtype == np.int32
    else:
        eng.follow()
spans = sorted({{e.key[len("repro_torch."):] for e in prof.key_averages()
                 if e.key.startswith("repro_torch.")}})
with open(f"{{tmp}}/rank{{rank}}.json", "w") as f:
    json.dump(dict(stats=eng.last_stats, spans=spans, k=eng.k, vl=eng.vl,
                   n_pad=eng.n_pad), f)
"""


def test_exchange_bytes_counted_by_hand_on_two_ranks(tmp_path):
    """Two ranks x 2 PEs, a wave of 40 roots (2 plane words): each kind's
    bytes as counted by hand from the levels run, on the leader and its
    follower; a profiler sees the engine's spans on both."""
    body = _graph_body(10, 2**31, 4, "beamer") + _COUNTS.format()
    run_ranks(body, 2, tmp_path)
    lead, follow = _rank_json(tmp_path, 2)
    st = lead["stats"]
    assert follow["stats"]["iterations"] == st["iterations"]
    assert st["push_iters"] > 0 and st["pull_iters"] > 0
    k, vl, n_pad, b, nwb, d = lead["k"], lead["vl"], lead["n_pad"], 40, 2, 2
    statvec = 7 + 2 * d                        # int32 sums + shard needs
    common = dict(
        # push: the candidate planes of every vertex, half to the peer
        crossbar=st["push_iters"] * n_pad * nwb * 4 // 2,
        # pull: this rank's frontier planes once to the peer
        all_gather=st["pull_iters"] * k * vl * nwb * 4,
        # one statvec a level and the first: a ring's 2 (d - 1) / d
        all_reduce=(st["iterations"] + 1) * statvec * 4)
    assert lead["stats"]["exchange_bytes"] == dict(
        common, gather=0, roots=8 * (4 + HEADER_ROOTS))
    assert follow["stats"]["exchange_bytes"] == dict(
        common, gather=k * vl * b * 4, roots=0)
    assert set(st["exchange_bytes"]) == set(EXCHANGE_KINDS)
    assert SPANS <= set(lead["spans"])
    assert SPANS | {"follow"} <= set(follow["spans"])
    assert "follow" not in lead["spans"]


_GROUP = """
import json, sys
import numpy as np
import torch
from repro_torch.core import bfs_oracle
from repro_torch.core.partition import partition_rank_shards
from repro_torch.graph import get_dataset
from repro_torch.launch.leader import start_group


def main(tmp):
    ds = get_dataset("small-12-8")
    t = torch.from_numpy
    shards = partition_rank_shards(t(ds.csr.indptr), t(ds.csr.indices),
                                   t(ds.csc.indptr), t(ds.csc.indices), 6, 3)
    group = start_group(shards, device="cpu",
                        init_method=f"file://{tmp}/store")
    del shards
    eng = group.engine
    roots = np.asarray([7, 100, 2000, 4095, 7])
    rows = eng.run_batch(roots)
    bad = sum(int((rows[i] != bfs_oracle(ds.csr, int(r))).sum())
              for i, r in enumerate(roots))
    bad += int((eng.run(100) != bfs_oracle(ds.csr, 100)).sum())
    held = rows
    again = eng.run_batch(roots)
    bad += int((again != held).sum())
    reports = group.close()
    print(json.dumps(dict(bad=bad, dtype=str(rows.dtype),
                          deg=bool(np.array_equal(
                              eng.out_deg, np.diff(ds.csr.indptr))),
                          reports=reports)))


if __name__ == "__main__":
    main(sys.argv[1])
"""


def test_start_group_serves_from_one_process(tmp_path):
    """``start_group`` on 3 gloo ranks: this process leads, two spawned
    followers are handed their shards through shared memory; the rows
    equal the oracle's, ``close()`` ends the followers, and their reports
    count the calls, name the device each ran on and hold no JAX."""
    get_dataset("small-12-8")                   # cached before the ranks
    r = subprocess.run([sys.executable, "-c", _GROUP, str(tmp_path)],
                       env=dict(_env(), OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == 0 and out["dtype"] == "int32" and out["deg"]
    assert [x["rank"] for x in out["reports"]] == [1, 2]
    for x in out["reports"]:
        assert x["error"] is None and x["calls"] == 3
        assert x["device"] == "cpu"
        assert not {"jax", "jaxlib", "repro"} & set(x["modules"])


@pytest.mark.parametrize("scheme", ["hash", "contiguous"])
@pytest.mark.parametrize("shards,ranks", [(4, 2), (8, 4), (6, 3), (3, 1)])
def test_rank_shards_on_tensors_equal_the_host_partition(scheme, shards,
                                                         ranks):
    ds = get_dataset("tiny-16-4")
    t = torch.from_numpy
    got = partition_rank_shards(t(ds.csr.indptr), t(ds.csr.indices),
                                t(ds.csc.indptr), t(ds.csc.indices),
                                shards, ranks, scheme=scheme)
    pg = partition_graph(ds.csr, ds.csc, shards, scheme=scheme)
    assert len(got) == ranks
    for r, block in enumerate(got):
        want = pg.rank_shards(r, shards // ranks)
        assert (block.rank, block.k, block.verts_per_shard,
                block.num_vertices_padded) == (
            r, shards // ranks, pg.verts_per_shard, pg.num_vertices_padded)
        for a, w in zip(block.tensors(), want.tensors()):
            assert a.dtype == w.dtype == torch.int32
            assert torch.equal(a, w)
    np.testing.assert_array_equal(got[0].out_deg, np.diff(ds.csr.indptr))
    assert all(b.out_deg is None for b in got[1:])


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()


def test_budget_is_the_largest_shards_need(one_rank, monkeypatch):
    """Every level's expansion budget is the smallest doubling of
    ``edge_budget`` that holds the largest shard's need (read from the
    statvec's per-shard slots), so no level overflows; the first statvec's
    slots equal the needs counted by hand."""
    ds = get_dataset("small-12-8")
    q = 4
    pg = partition_graph(ds.csr, ds.csc, q)
    eng = DistributedBFS(pg, one_rank, cfg=DistConfig(edge_budget=1))
    svs, budgets = [], []
    fetch = eng._fetch_sv

    def spy_fetch(sv):
        svs.append(fetch(sv))
        return svs[-1]

    def spy(step):
        def call(*a, **kw):
            budgets.append((a[4], step.__name__))
            return step(*a, **kw)
        return call

    monkeypatch.setattr(eng, "_fetch_sv", spy_fetch)
    monkeypatch.setattr(eng, "_push_b", spy(eng._push_b))
    monkeypatch.setattr(eng, "_pull_b", spy(eng._pull_b))
    roots = np.asarray([7, 100, 2000, 4095])
    rows = eng.run_batch(roots)
    assert rows.dtype == np.int32
    it = eng.last_stats["iterations"]
    assert len(budgets) == it and len(svs) == it + 1      # no retry
    budget = 1
    for sv, (got, name) in zip(svs, budgets):
        need = eng._shard_need(sv, name == "_push_b")
        while budget < need:
            budget *= 2
        assert got == budget and got >= need
    # the first statvec's shard needs, by hand
    vl = pg.verts_per_shard
    pos = (roots % q) * vl + roots // q
    out_deg = np.diff(pg.out_indptr, axis=1)
    push = [out_deg[s][np.unique(pos[pos // vl == s] % vl)].sum()
            for s in range(q)]
    pull = [pg.in_indptr[s, -1] for s in range(q)]
    assert svs[0][7] == max(push) and svs[0][8] == max(pull)
    assert len(svs[0]) == 9


def test_shards_and_whole_partition_give_one_engine(one_rank):
    """An engine built from ``RankShards`` answers as one built from the
    whole ``PartitionedGraph``; a rank handed another rank's shards is
    refused."""
    ds = get_dataset("small-12-8")
    t = torch.from_numpy
    pg = partition_graph(ds.csr, ds.csc, 4)
    shards = partition_rank_shards(t(ds.csr.indptr), t(ds.csr.indices),
                                   t(ds.csc.indptr), t(ds.csc.indices), 4, 1)
    roots = np.asarray([7, 100, 2000, 4095, 7])
    whole = DistributedBFS(pg, one_rank, cfg=DistConfig(
        scheduler=SchedulerConfig(policy="beamer")))
    mine = DistributedBFS(shards[0], one_rank, cfg=DistConfig(
        scheduler=SchedulerConfig(policy="beamer")))
    np.testing.assert_array_equal(whole.run_batch(roots),
                                  mine.run_batch(roots))
    np.testing.assert_array_equal(whole.out_deg, mine.out_deg)
    np.testing.assert_array_equal(whole.run(100), mine.run(100))
    other = partition_rank_shards(t(ds.csr.indptr), t(ds.csr.indices),
                                  t(ds.csc.indptr), t(ds.csc.indices), 4, 2)
    with pytest.raises(ValueError, match="given to rank"):
        DistributedBFS(other[1], one_rank)
    with pytest.raises(RuntimeError, match="leader"):
        mine.follow()


def test_readback_reuses_the_pool_on_the_leader(one_rank):
    """The leader's rows come through the page-locked pool (it engages on
    the card only: here ``HostPool`` stands in, as in
    ``test_torch_readback``), and a held answer keeps its block."""
    from test_torch_readback import HostPool
    ds = get_dataset("small-12-8")
    eng = DistributedBFS(partition_graph(ds.csr, ds.csc, 2), one_rank)
    eng._pool = HostPool()
    roots = np.asarray([7, 100, 2000])
    first = eng.run_batch(roots)
    keep = first.copy()
    second = eng.run_batch(roots[::-1])
    np.testing.assert_array_equal(first, keep)
    np.testing.assert_array_equal(second[::-1], first)
    third = eng.run_batch(roots)
    np.testing.assert_array_equal(third, keep)
    st = eng.last_stats["readback"]
    assert st["readbacks"] == 3 and st["blocks"] == 3 and st["grown"] == 3
    del first, second, third
    eng.run_batch(roots)
    st = eng.last_stats["readback"]
    assert st["readbacks"] == 4 and st["grown"] == 3        # reused
    assert eng.last_stats["seconds"] > 0
