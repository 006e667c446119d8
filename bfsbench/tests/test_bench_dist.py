"""The four-rank cell rehearsed on the CPU: a tiny ``dist4``-like cell
(``loops/dist_batch.py`` on 4 gloo ranks, this process the leader and
three spawned followers) added by files alone, and a planted fault in
one follower that ``correct`` must catch."""
from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest
from conftest import add_cell, run_tiny

DIST = {"entry": "dist_batch", "batch": 32,
        "runner": {"ranks": 4, "pes_per_rank": 2, "dispatch": "bitmap",
                   "crossbar": "staged"}}
LAYERS = ("levels_ms.dist4", "exchange_ms.dist4", "exchange_roofline.dist4",
          "readback_ms.dist4", "idle_share.dist4", "k2_roofline.dist4",
          "glue_device_ms.dist4", "syncs_per_level.dist4")

# A follower whose rank 1 never commits its shards' levels: its vertices
# keep INF in every plane but their roots.
FAULTY = '''
import dataclasses

from repro_torch.launch import leader


def follower(rank, *args):
    if rank == 1:
        from repro_torch.core import bfs_distributed as bd
        run = bd.DistributedBFS._run_batch

        def skip(self, program, roots, max_iters):
            lazy = dataclasses.replace(program,
                                       commit=lambda value, new, lvl: value)
            return run(self, lazy, roots, max_iters)
        bd.DistributedBFS._run_batch = skip
    leader._follower(rank, *args)
'''


def _snapshot(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_dist_cell_by_files_alone(bench_copy):
    """A mix naming ``dist_batch`` and its cell: the harness runs it with no
    edit to a file that was there, traced and untraced, and every rank's
    answers pass the reference."""
    before = _snapshot(bench_copy)
    add_cell(bench_copy.parent, "tiny.dist4cpu", DIST, per_layer=LAYERS)
    for trace in (False, True):
        out = run_tiny(bench_copy, "tiny.dist4cpu", seed=2**31 + 21,
                       seconds=0.5, trace=trace)
        assert out["correct"], out["checks"]
        assert out["attempted"] % 32 == 0 and out["attempted"] > 0
        got = set(out["metrics"])
        if trace:
            # no device on the CPU: the device-trace readers stay silent,
            # the program-span readers read
            assert got == {"levels_ms.dist4", "readback_ms.dist4",
                           "syncs_per_level.dist4"}
        else:
            assert got == {"teps", "setup_s"}
        # four gloo ranks on one device, the CPU
        assert out["device"]["count"] == 1
    after = _snapshot(bench_copy)
    assert set(after) - set(before) == {Path("traffic/dist4cpu.json")}
    assert all(after[k] == v for k, v in before.items())


def test_a_follower_that_skips_its_commit_is_caught(bench_copy, tmp_path,
                                                    monkeypatch):
    (tmp_path / "faulty_rank.py").write_text(textwrap.dedent(FAULTY))
    monkeypatch.syspath_prepend(str(tmp_path))
    import faulty_rank

    from repro_torch.launch import leader
    monkeypatch.setattr(leader, "_follower", faulty_rank.follower)
    add_cell(bench_copy.parent, "tiny.dist4cpu", DIST)
    out = run_tiny(bench_copy, "tiny.dist4cpu", seed=2**31 + 22,
                   seconds=0.5)
    assert not out["correct"]
    assert out["checks"]["mismatched_levels"]["value"] > 0


@pytest.mark.parametrize("devices,count", [
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 4),
    (["cpu", "cpu", "cpu", "cpu"], 1)])
def test_result_line_counts_the_ranks_devices(monkeypatch, devices, count):
    """Once the group is closed, the harness's next result line counts
    the devices the ranks ran on, and the one after it is the harness's
    own again."""
    import types

    import numpy as np

    from bfsbench import harness
    from bfsbench.loops import dist_batch

    def own(*args, **kw):
        return {"device": {"count": 1}}
    monkeypatch.setattr(harness, "result", own)
    entry = types.SimpleNamespace(devices=list(devices))
    loop = dist_batch.DistLoop(entry, 4, np.arange(8),
                               np.random.default_rng(0), None)
    loop.close()
    assert harness.result()["device"]["count"] == count
    assert harness.result is own


def _closed_entry(devices):
    from bfsbench.loops import dist_batch
    entry = object.__new__(dist_batch.Entry)
    entry.engine, entry.devices = None, [devices[0]]
    reports = [dict(rank=r, calls=3, device=d, peak_bytes=None, error=None,
                    modules=["torch", "repro_torch"])
               for r, d in enumerate(devices[1:], start=1)]
    entry.group = type("G", (), {"close": lambda self: reports})()
    entry.close()
    return entry


def test_ranks_on_distinct_cards_pass_and_shared_cards_fail():
    cards = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert _closed_entry(cards).devices == cards
    with pytest.raises(RuntimeError, match="shared cards"):
        _closed_entry(["cuda:0", "cuda:1", "cuda:1", "cuda:3"])


def test_spec_lists_the_four_card_cell():
    from conftest import ROOT
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == "kron25-16.dist4")
    assert cell["chips"] == 4 and cell["traffic"] == "dist4"
    for name in LAYERS:
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["kron25-16.dist4"] and m["moves"] == "teps"
    assert "kron25-16.dist4" in next(
        m for m in spec["end_to_end"] if m["name"] == "teps")["workloads"]
    with pytest.raises(StopIteration):
        next(m for m in spec["per_layer"]
             if m["name"].endswith(".dist4") and m["name"] not in LAYERS)


def test_launches_at_one_start_read_alike(monkeypatch):
    """Two device operations at one start, one launch on record and one
    not (NCCL's kernel beside the step's on four cards): the program
    reader of ``program_trace`` cannot order them; ``launch_order``'s
    reads them, and reads a trace without such a tie as the original."""
    import types

    import torch
    from test_bench_program_trace import _ThreadedEvent as ev

    from bfsbench import launch_order, program_trace, trace
    for owner, name in ((program_trace, "read_program"),
                        (trace, "read_profile"), (trace.Tracer, "start")):
        monkeypatch.setattr(owner, name, getattr(owner, name))
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def events(tie: bool) -> list:
        return [ev("bfsbench.window", cpu, 0, 100, thread=1),
                ev("repro_torch.level", cpu, 5, 60, thread=1),
                ev("cudaLaunchKernel", cpu, 6, 1, thread=1, corr=4),
                ev("cudaLaunchKernel", cpu, 30, 1, thread=1, corr=5),
                ev("k_step", cuda, 20, 5, corr=4),
                ev("ncclDevKernel_AllGather", cuda, 20 if tie else 21, 9,
                   corr=9),
                ev("k_commit", cuda, 40, 5, corr=5)]

    def base(evs):
        return trace.Trace([(e.name(), *trace._times(e)) for e in evs
                            if e.device_type() == cuda], [],
                           [("window", 0, 100000)])

    # the original, even where an earlier traced run installed the new one
    original = launch_order._BASE
    with pytest.raises(TypeError):
        original(events(True), base(events(True)))
    got = launch_order.read_program(events(True), base(events(True)))
    assert got.launched == [(20000, None), (20000, 1), (40000, 1)]
    plain = events(False)
    assert launch_order.read_program(plain, base(plain)) == \
        original(plain, base(plain))
    launch_order.install()
    assert program_trace.read_program is launch_order.read_program
    assert trace.read_profile is program_trace.read_profile


def test_k2_count_is_queued_on_the_card(monkeypatch):
    """The loop's K2 hook leaves the call's answer as it was and queues
    the frozen byte count as a tensor, with no synchronisation: a pause
    of the leader alone would let the followers run ahead."""
    import torch

    from bfsbench import yardstick_dist
    from bfsbench.loops import dist_batch
    from repro_torch.kernels import msbfs_propagate, ops

    def k2(seen, msg, tgt, chunk_tile, tile_chunks, tile_rows, block_edges,
           op="or"):
        return seen + 1

    for mod in (msbfs_propagate, ops):
        monkeypatch.setattr(mod, "msbfs_propagate_planes_tiled", k2)

    def no_sync(*a, **kw):
        raise AssertionError("the K2 hook synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    queued: list = []
    undo = dist_batch._hook_k2(queued)
    try:
        assert {o for _, _, o in undo} == {k2} and len(undo) >= 2
        seen = torch.zeros((16, 2), dtype=torch.int32)
        msg = torch.zeros((24, 2), dtype=torch.int32)
        msg[[1, 5, 9], 0] = 3
        msg[9, 1] = 1
        tile_chunks = torch.tensor([2, -1, 1], dtype=torch.int32)
        out = ops.msbfs_propagate_planes_tiled(
            seen, msg, msg[:, 0], tile_chunks, tile_chunks, 8, 8)
    finally:
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)
    assert torch.equal(out, seen + 1)
    assert ops.msbfs_propagate_planes_tiled is k2
    (got,) = queued
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    # 3 head chunks of 8 slots, 2 words a slot; 3 live targets; seen
    # read, new and seen_out written; the count
    assert int(got) == 3 * 8 * 2 * 4 + 3 * 4 + 3 * 32 * 4 + 4
    assert int(got) == int(yardstick_dist.k2_bytes(seen, msg, tile_chunks,
                                                   8))


def _dist_trace():
    """A traced window with two NCCL kernels in a level (1 ms each), one
    inside the program's readback span (the gather, 4 ms), a kernel of the
    port (K2, 2 ms) and one of the step glue (3 ms)."""
    import dataclasses

    from bfsbench import program_trace, trace
    ms = 1_000_000
    base = trace.Trace(
        kernels=[("ncclDevKernel_SendRecv", 10 * ms, 11 * ms),
                 ("ncclDevKernel_AllGather", 20 * ms, 21 * ms),
                 ("propagate_tiled_kernel<4>", 30 * ms, 32 * ms),
                 ("at::native::cumsum_kernel", 40 * ms, 43 * ms),
                 ("ncclDevKernel_Gather", 61 * ms, 65 * ms)],
        copies=[], spans=[("window", 0, 100 * ms)])
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(trace.Trace)}
    return program_trace.ProgramTrace(
        **fields, program=[("level", 5 * ms, 50 * ms, 1),
                           ("readback", 60 * ms, 70 * ms, 1)],
        threaded=[("window", 0, 100 * ms, 1)])


def _dist_run(tr, calls):
    import types

    import numpy as np
    import torch

    from bfsbench import drive, harness
    run = harness.Run(cell={}, config={}, mix={}, seed=0,
                      device=torch.device("cpu"))
    run.units = [drive.Unit(0.0, 0.1, np.arange(4), True, 0.05, 0.0)]
    run.probe = types.SimpleNamespace(dist_calls=calls, k2_bytes=[])
    run.trace = tr
    return run


def test_exchange_roofline_leaves_the_gather_out(undo_install):
    """The leader's sent bytes (the gather's, which it only receives,
    left out) over NCCL's device time outside the readback spans."""
    from bfsbench import harness, yardstick_dist
    calls = [{"exchange_bytes": {"crossbar": 600e6, "all_gather": 300e6,
                                 "all_reduce": 0.0, "gather": 7e9,
                                 "roots": 256}}]
    read = harness.load_metric("exchange_roofline.dist4").read
    got = read(_dist_run(_dist_trace(), calls))
    want = yardstick_dist.link_share(600e6 + 300e6 + 256, 2e-3)
    assert got == pytest.approx(want)
    assert read(_dist_run(_dist_trace(), [])) is None


def test_glue_of_the_four_card_cell_leaves_nccl_and_k2_out(undo_install):
    from bfsbench import harness
    read = harness.load_metric("glue_device_ms.dist4").read
    assert read(_dist_run(_dist_trace(), [{}])) == pytest.approx(3.0)


@pytest.fixture
def undo_install(monkeypatch):
    """What the metrics' ``install()`` replaces is put back after the
    test."""
    from bfsbench import program_trace, trace
    monkeypatch.setattr(trace.Tracer, "start", trace.Tracer.start)
    monkeypatch.setattr(trace, "read_profile", trace.read_profile)
    monkeypatch.setattr(program_trace, "read_program",
                        program_trace.read_program)
