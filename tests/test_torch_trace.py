"""The port's phase spans (``repro_torch.trace``) on the CPU: the engines'
and the batcher's spans under ``torch.profiler``, nested as documented,
one ``level`` a level, every blocking fetch under a named phase; the
gate that keeps them off without a profiler, on every thread; and the
counters beside them (``BFSRunner.last_level_seconds``,
``WaveStats.t_dispatch`` / ``t_engine_done``)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import bfs_local, vertex_program
from repro_torch.core.bfs_local import (SV_OVERFLOW, BFSRunner,
                                        build_local_graph)
from repro_torch.core.vertex_program import MultiSourceBFSRunner
from repro_torch.graph import csr_from_edges, rmat_edges, transpose_csr
from repro_torch.launch.dynbatch import DynamicBatcher

STEP_PHASES = {"expand", "propagate", "commit", "statvec"}
PHASES = ("init", "statvec_fetch", "retry", "readback")


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(9, 8, seed=3)
    csr = csr_from_edges(src, dst, 1 << 9)
    g = build_local_graph(csr, transpose_csr(csr), device="cpu")
    roots = np.flatnonzero(np.diff(csr.indptr) > 0)
    return g, roots


def all_threads():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def spans_of(prof) -> list:
    """(name without the prefix, start, end, thread) of the program's
    spans, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(trace.PREFIX):
            s = e.start_ns()
            out.append((name[len(trace.PREFIX):], s, s + e.duration_ns(),
                        e.start_thread_id()))
    return sorted(out, key=lambda sp: (sp[1], -sp[2]))


def parent_of(spans, sp):
    """The innermost other span on ``sp``'s thread that holds it."""
    holders = [o for o in spans if o is not sp and o[3] == sp[3]
               and o[1] <= sp[1] and sp[2] <= o[2]]
    return max(holders, key=lambda o: (o[1], -o[2]))[0] if holders else None


def overflow_once(step):
    """``step`` whose first call reports an overflow: the runner retries
    the level once."""
    calls = []

    def wrapped(*args, **kw):
        out = step(*args, **kw)
        calls.append(1)
        if len(calls) > 1:
            return out
        sv = out[-1].clone()
        sv[SV_OVERFLOW] = 1
        return (*out[:-1], sv)
    return wrapped


def fetch_counted(runner):
    """Open a ``fetch`` range around each of the runner's blocking
    fetches, so the profile shows which phase each one sits in."""
    fetch = runner._fetch

    def counted(t):
        with torch.profiler.record_function("repro_torch.fetch"):
            return fetch(t)
    runner._fetch = counted


@pytest.mark.parametrize("retry", [False, True], ids=["plain", "retry"])
@pytest.mark.parametrize("engine", ["single", "batch"])
def test_engine_spans_nest(graph, monkeypatch, engine, retry):
    g, roots = graph
    if engine == "single":
        runner = BFSRunner(g, use_kernels=True)
        if retry:
            monkeypatch.setattr(bfs_local, "push_step",
                                overflow_once(bfs_local.push_step))

        def run():
            res = runner.run(int(roots[5]))
            return res.iterations, res.host_transfers, res.overflow_retries
    else:
        runner = MultiSourceBFSRunner(g, use_kernels=True)
        if retry:
            monkeypatch.setattr(vertex_program, "vp_push_step",
                                overflow_once(vertex_program.vp_push_step))

        def run():
            runner.run_batch(roots[:40])
            st = runner.last_stats
            return (st["iterations"], st["host_transfers"],
                    st["overflow_retries"])
    fetch_counted(runner)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        iterations, transfers, retries = run()
    spans = spans_of(prof)
    names = [sp[0] for sp in spans]
    assert retries == int(retry) and iterations > 2
    assert names.count("level") == iterations
    assert len(runner.last_level_seconds) == iterations
    assert all(s > 0 for s in runner.last_level_seconds)
    assert names.count("retry") == retries
    assert [names.count(n) for n in ("init", "readback", "count")] == [1] * 3
    levels = [sp for sp in spans if sp[0] == "level"]
    assert spans[0][0] == "init" and spans[0][2] <= levels[0][1]
    after = [sp for sp in spans if sp[0] in ("readback", "count")]
    assert all(sp[1] >= levels[-1][2] for sp in after)
    for sp in spans:
        parent = parent_of(spans, sp)
        if sp[0] in ("step", "statvec_fetch", "retry"):
            assert parent == "level", sp
        elif sp[0] in STEP_PHASES:
            assert parent in ("step", "retry"), sp
        elif sp[0] == "fetch":
            assert parent in PHASES, sp
        else:
            assert parent is None, sp
    for kind in ("step", "retry"):
        for sp in (s for s in spans if s[0] == kind):
            held = {o[0] for o in spans if parent_of(spans, o) == kind
                    and sp[1] <= o[1] and o[2] <= sp[2]}
            assert {"expand", "propagate", "commit", "statvec"} <= held
    # every blocking fetch sits in one of the four phases and they add
    # up to the runner's own count
    assert names.count("fetch") == transfers == iterations + retries + 2


def test_no_profiler_enters_no_record_function(graph, monkeypatch):
    g, roots = graph

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.profiling()
    assert trace.span("level", 3) is trace.span("step")
    BFSRunner(g, use_kernels=True).run(int(roots[1]))
    runner = MultiSourceBFSRunner(g, use_kernels=True)
    runner.run_batch(roots[:8])
    b = DynamicBatcher(runner, max_batch=32, window=0.0, clock=lambda: 0.0)
    fut = b.submit(int(roots[2]))
    b.flush()
    assert fut.result(timeout=0)[int(roots[2])] == 0


@pytest.mark.parametrize("profiled", [True, False])
def test_gate_reads_on_worker_threads(profiled):
    """The gate is the profiler's process-global flag: true on a thread
    the profiler did not start from, false once it stopped."""
    seen = []

    def look():
        seen.append(trace.profiling())
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            t = threading.Thread(target=look)
            t.start()
            t.join(timeout=30)
    else:
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [profiled]
    assert not trace.profiling()


def test_batcher_spans_link_waves_across_threads(graph, monkeypatch):
    """A pipelined batcher under a profiler that records every thread:
    cut, execute and finish on three threads, each wave's three spans
    carrying the same cut number, the engine's levels on the
    dispatcher's thread."""
    g, roots = graph
    real = torch.profiler.record_function
    opened = []

    def recording(name, args=None):
        opened.append((name, args, threading.get_ident()))
        return real(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    runner = MultiSourceBFSRunner(g, use_kernels=True)
    runner.run_batch(roots[:32])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=all_threads()) as prof:
        b = DynamicBatcher(runner, max_batch=32, window=0.005, pipeline=True)
        futs = [b.submit(int(r)) for r in roots[:70]]
        for f in futs:
            f.result(timeout=120)
        b.close(drain=True, timeout=120)
    stages = ("batcher.cut", "batcher.execute", "batcher.finish")
    by_stage = {st: [(a, tid) for n, a, tid in opened
                     if n == trace.PREFIX + st] for st in stages}
    waves = [sorted(int(a) for a, _ in by_stage[st]) for st in stages]
    assert waves[0] == waves[1] == waves[2]
    assert waves[0] == list(range(len(b.waves))) and len(b.waves) >= 3
    assert len({tid for st in stages for _, tid in by_stage[st]}) == 3
    spans = spans_of(prof)
    thread = {st: {sp[3] for sp in spans if sp[0] == st} for st in stages}
    assert all(len(t) == 1 for t in thread.values())
    assert len(set.union(*thread.values())) == 3
    level_threads = {sp[3] for sp in spans if sp[0] == "level"}
    assert level_threads == thread["batcher.execute"]
    for ws in b.waves:
        assert ws.t_start <= ws.t_dispatch <= ws.t_engine_done


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _SlowEngine:
    """The runner, with the batcher's clock moved on by each call."""

    def __init__(self, runner, clock, seconds):
        self.runner, self.clock, self.seconds = runner, clock, seconds
        self.num_vertices = runner.num_vertices
        self.out_deg = runner.out_deg
        self.last_stats = {}

    def run_batch(self, roots):
        self.clock.t += self.seconds
        rows = self.runner.run_batch(roots)
        self.last_stats = self.runner.last_stats
        if self.seconds < 0:
            raise RuntimeError("engine fault")
        return rows


@pytest.mark.parametrize("seconds", [0.25, -1.0], ids=["ok", "raises"])
def test_wave_stamps_engine_entry_and_return(graph, seconds):
    g, roots = graph
    clock = _Clock()
    engine = _SlowEngine(MultiSourceBFSRunner(g, use_kernels=True), clock,
                         seconds)
    b = DynamicBatcher(engine, max_batch=32, window=0.1, clock=clock)
    futs = [b.submit(int(r)) for r in roots[:3]]
    clock.t = 0.5
    ws = b.pump()
    assert ws.t_start == 0.5 and ws.t_dispatch == 0.5
    assert ws.t_engine_done == 0.5 + seconds
    assert all(f.done() for f in futs)
    assert (ws.error is None) == (seconds > 0)
