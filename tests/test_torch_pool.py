"""The port's worker pool (``repro_torch.launch.pool``) against the
reference's (``repro.launch.pool``).

Each case builds both packages' pools over independent runners sharing one
graph per package (the reference's ``LocalGraph`` carried across with
``interop.local_graph_from_numpy``), drives them with the same submits and
fake clock, and compares every future's row (bit for bit) or error type,
the routing (per-worker backlogs), the health states and the pool's stats
(less the busy and idle seconds and the TEPS read from them).  The
reference tests' own assertions (``tests/test_pool.py``) run under both;
the real-clock pipelined pool compares rows only.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.ft as jft                                     # noqa: E402
import repro.launch.dynbatch as jdyn                       # noqa: E402
import repro.launch.pool as jpool                          # noqa: E402
from repro.core import MultiSourceBFSRunner as JMS         # noqa: E402
from repro.core import bfs_oracle                          # noqa: E402
from repro.core import build_local_graph as j_build_local_graph  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro.graph import uniform_edges as j_uniform_edges   # noqa: E402
import repro_torch.ft as tft                               # noqa: E402
import repro_torch.launch.dynbatch as tdyn                 # noqa: E402
import repro_torch.launch.pool as tpool                    # noqa: E402
from repro_torch.core import MultiSourceBFSRunner as TMS   # noqa: E402
from repro_torch.interop import local_graph_from_numpy     # noqa: E402

N = 256
WALL_STATS = ("busy_seconds", "engine_idle_seconds", "aggregate_teps")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


@pytest.fixture(scope="module")
def graph():
    src, dst = j_uniform_edges(N, 1024, seed=7)
    csr = j_csr_from_edges(src, dst, N)
    jg = j_build_local_graph(csr, j_transpose_csr(csr))
    fields = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name not in ("n", "n_pad")}
    tg = local_graph_from_numpy(fields, jg.n, jg.n_pad, device="cpu")
    ref = SimpleNamespace(name="ref", pool=jpool, dyn=jdyn, ft=jft,
                          runner=lambda: JMS(jg))
    port = SimpleNamespace(name="port", pool=tpool, dyn=tdyn, ft=tft,
                           runner=lambda: TMS(tg))
    return SimpleNamespace(csr=csr, pkgs=(ref, port))


def both(graph, scenario):
    ref, port = graph.pkgs
    a, b = scenario(ref), scenario(port)
    assert a == b
    return b


def oracle(graph, r):
    return bfs_oracle(graph.csr, int(r))


def fut(f):
    exc = f.exception() if f.done() else None
    row = (np.asarray(f.result(timeout=0), np.int64).tobytes()
           if f.done() and exc is None else None)
    return (f.root, f.done(), row,
            None if exc is None else type(exc).__name__, f.latency,
            f.slo_miss)


def st(s):
    """Pool stats less wall-clock seconds, also per worker."""
    s = {k: v for k, v in s.items() if k not in WALL_STATS}
    s["per_worker"] = [{k: v for k, v in p.items()
                        if k not in WALL_STATS
                        and k != "fault_tolerance"}
                       for p in s["per_worker"]]
    if "fault_tolerance" in s:
        s["fault_tolerance"] = [
            {k: v for k, v in (ft or {}).items()
             if k not in ("stragglers", "wave_deadline")}
            for ft in s["fault_tolerance"]]
    return s


def engines(P, k=2):
    # independent runners over ONE device-resident graph
    return [P.runner() for _ in range(k)]


class DeadEngine:
    """BFSEngine-protocol double for a permanently dead worker."""

    num_vertices = N

    def __init__(self):
        self.calls = 0

    def run_batch(self, roots, **kw):
        self.calls += 1
        raise RuntimeError("engine dead")


def test_pool_needs_at_least_one_engine(graph):
    for P in graph.pkgs:
        with pytest.raises(ValueError):
            P.pool.WorkerPool([])


def test_pool_spreads_requests_and_matches_oracle(graph):
    roots = [2, 50, 100, 150, 200, 250, 33, 77]

    def scenario(P):
        es = engines(P)
        pool = P.pool.WorkerPool(es, out_deg=np.asarray(es[0].out_deg),
                                 window=1.0, max_batch=32, clock=FakeClock())
        futures = [pool.submit(r, block=False) for r in roots]
        assert pool.backlog() == len(roots)
        waves = pool.flush()
        assert len(waves) == 2 and pool.backlog() == 0
        for f, r in zip(futures, roots):
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        s = pool.stats()
        assert s["workers"] == 2 and s["waves"] == 2
        assert [p["requests"] for p in s["per_worker"]] == [4, 4]
        assert s["traversed_edges"] == sum(
            p["traversed_edges"] for p in s["per_worker"])
        assert s["latency_p99"] >= s["latency_p50"] >= 0
        pool.close()
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_pool_routes_to_least_backlogged_worker(graph):
    def scenario(P):
        pool = P.pool.WorkerPool(engines(P), window=1.0, clock=FakeClock())
        for r in (1, 2, 3):
            pool.submit(r, block=False)
        loads = [w.backlog() for w in pool.workers]
        assert sorted(loads) == [1, 2]
        light = min(pool.workers, key=lambda w: w.backlog())
        pool.submit(4, block=False)
        assert light.backlog() == 2
        after = [w.backlog() for w in pool.workers]
        pool.flush()
        pool.close()
        return loads, after
    both(graph, scenario)


def test_pool_queuefull_failover_and_exhaustion(graph):
    def scenario(P):
        pool = P.pool.WorkerPool(engines(P), window=1.0, max_pending=1,
                                 clock=FakeClock())
        pool.submit(1, block=False)
        pool.submit(2, block=False)
        with pytest.raises(P.dyn.QueueFull):
            pool.submit(3, block=False)
        pool.flush()
        f = pool.submit(3, block=False)
        pool.close(drain=True)
        return fut(f), st(pool.stats())
    both(graph, scenario)


def test_pool_slo_accounting_merges(graph):
    def scenario(P):
        clock = FakeClock()
        pool = P.pool.WorkerPool(engines(P), window=0.1, clock=clock,
                                 slo_margin=0.0)
        f_ok = pool.submit(5, block=False, deadline=10.0)
        f_late = pool.submit(7, block=False, deadline=0.5)
        clock.advance(1.0)
        pool.flush()
        assert f_ok.slo_miss is False and f_late.slo_miss is True
        s = pool.stats()
        assert s["slo_requests"] == 2 and s["slo_misses"] == 1
        assert s["slo_miss_rate"] == 0.5
        np.testing.assert_array_equal(np.asarray(f_late.result(), np.int64),
                                      oracle(graph, 7))
        pool.close()
        return fut(f_ok), fut(f_late), st(s)
    both(graph, scenario)


def test_pool_close_closes_every_worker(graph):
    def scenario(P):
        pool = P.pool.WorkerPool(engines(P), window=1.0, clock=FakeClock())
        f = pool.submit(9, block=False)
        pool.close(drain=True)
        assert f.done() and f.exception() is None
        for w in pool.workers:
            with pytest.raises(P.dyn.BatcherClosed):
                w.submit(1, block=False)
        return fut(f)
    both(graph, scenario)


def test_pool_per_worker_supervision(graph):
    roots = [3, 42, 17, 99]

    def scenario(P):
        es = engines(P)
        sups = [P.ft.EngineSupervisor(P.ft.FaultyEngine(e,
                                                        poisoned_roots=[42]),
                                      backoff=0.0, watchdog=False)
                for e in es]
        pool = P.pool.WorkerPool(sups, out_deg=np.asarray(es[0].out_deg),
                                 window=1.0, clock=FakeClock())
        futures = [pool.submit(r, block=False) for r in roots]
        pool.flush()
        for f, r in zip(futures, roots):
            if r == 42:
                assert isinstance(f.exception(), P.ft.RequestQuarantined)
            else:
                np.testing.assert_array_equal(
                    np.asarray(f.result(timeout=0), np.int64),
                    oracle(graph, r))
        s = pool.stats()
        assert s["requests_failed"] == 1 and len(s["fault_tolerance"]) == 2
        assert sorted(q for ft in s["fault_tolerance"]
                      for q in ft["quarantined"]) == [42]
        pool.close()
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_threaded_pipelined_pool_matches_oracle(graph):
    roots = [2, 50, 100, 150, 200, 250]

    def scenario(P):
        with P.pool.WorkerPool(engines(P), window=0.02, max_batch=64,
                               pipeline=True) as pool:
            futures = [pool.submit(r) for r in roots]
            levels = [f.result(timeout=120.0) for f in futures]
        for lv, r in zip(levels, roots):
            np.testing.assert_array_equal(np.asarray(lv, np.int64),
                                          oracle(graph, r))
        s = pool.stats()
        assert s["pipeline"] is True and s["requests"] == len(roots)
        return [np.asarray(lv, np.int64).tobytes() for lv in levels]
    both(graph, scenario)


# ---------------------------------------------------------------------------
# health state machine: eviction, redispatch, probe re-admission, shedding
# ---------------------------------------------------------------------------

def test_pool_validates_health_thresholds(graph):
    for P in graph.pkgs:
        with pytest.raises(ValueError):
            P.pool.WorkerPool(engines(P), evict_after=0)
        with pytest.raises(ValueError):
            P.pool.WorkerPool(engines(P), evict_after=2, suspect_after=3)


def test_dead_worker_evicted_within_threshold_all_futures_resolve(graph):
    roots = [2, 50, 100, 150, 200, 250, 33, 77]

    def scenario(P):
        dead = DeadEngine()
        live = P.runner()
        pool = P.pool.WorkerPool([dead, live],
                                 out_deg=np.asarray(live.out_deg),
                                 evict_after=2, window=1.0, max_batch=2,
                                 clock=FakeClock())
        futures = [pool.submit(r, block=False) for r in roots]
        pool.flush()
        assert all(f.done() for f in futures)
        for f, r in zip(futures, roots):
            assert f.exception() is None, f"root {r}: {f.exception()!r}"
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        s = pool.stats()
        assert s["health"] == [P.pool.EVICTED, P.pool.HEALTHY]
        assert s["evictions"] == 1 and s["redispatches"] >= 4
        assert "requests_failed" not in s
        assert s["per_worker"][0]["errors"] == 2 and dead.calls == 2
        pool.close(drain=True)
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_probe_readmits_with_replacement_engine(graph):
    def scenario(P):
        pool = P.pool.WorkerPool([DeadEngine(), P.runner()], evict_after=1,
                                 window=1.0, clock=FakeClock(),
                                 engine_factory=lambda idx: P.runner())
        f = pool.workers[0].submit(7, block=False)
        pool.flush()
        h1 = pool.health()
        assert h1 == [P.pool.EVICTED, P.pool.HEALTHY]
        assert f.exception() is None
        assert pool.probe_evicted() == 1
        assert pool.health() == [P.pool.HEALTHY, P.pool.HEALTHY]
        f2 = pool.workers[0].submit(9, block=False)
        pool.flush()
        np.testing.assert_array_equal(np.asarray(f2.result(), np.int64),
                                      oracle(graph, 9))
        s = pool.stats()
        assert s["probes"] == 1 and s["probe_failures"] == 0
        pool.close()
        return fut(f), fut(f2), h1, st(s)
    both(graph, scenario)


def test_probe_without_factory_keeps_dead_worker_evicted(graph):
    def scenario(P):
        pool = P.pool.WorkerPool([DeadEngine(), P.runner()], evict_after=1,
                                 window=1.0, clock=FakeClock())
        pool.workers[0].submit(7, block=False)
        pool.flush()
        assert pool.probe_evicted() == 0
        assert pool.health() == [P.pool.EVICTED, P.pool.HEALTHY]
        s = pool.stats()
        assert s["probes"] == 1 and s["probe_failures"] == 1
        pool.close()
        return st(s)
    both(graph, scenario)


def test_suspect_worker_ranked_last_then_recovers(graph):
    def scenario(P):
        es = engines(P)
        flaky = P.ft.FaultyEngine(es[0], P.ft.FaultPlan([(0, "kernel")]))
        pool = P.pool.WorkerPool([flaky, es[1]], evict_after=3,
                                 suspect_after=1, window=1.0,
                                 clock=FakeClock())
        f = pool.workers[0].submit(5, block=False)
        pool.flush()
        assert pool.health() == [P.pool.SUSPECT, P.pool.HEALTHY]
        assert f.exception() is None
        pool.submit(11, block=False)
        assert pool.workers[0].backlog() == 0
        assert pool.workers[1].backlog() == 1
        pool.flush()
        f2 = pool.workers[0].submit(13, block=False)
        pool.flush()
        assert f2.exception() is None
        assert pool.health() == [P.pool.HEALTHY, P.pool.HEALTHY]
        pool.close()
        return fut(f), fut(f2), st(pool.stats())
    both(graph, scenario)


def test_pool_shed_rejects_doomed_deadline_typed(graph):
    def scenario(P):
        pool = P.pool.WorkerPool(engines(P), shed=True, window=1.0,
                                 clock=FakeClock(), service_hint=1.0)
        ok = pool.submit(3, block=False, deadline=10.0)
        with pytest.raises(P.dyn.Overloaded):
            pool.submit(5, block=False, deadline=0.25)
        plain = pool.submit(7, block=False)
        pool.flush()
        assert ok.exception() is None
        assert pool.stats()["shed"] == 1
        pool.close()
        return fut(ok), fut(plain), st(pool.stats())
    both(graph, scenario)


def test_all_workers_evicted_raises_overloaded(graph):
    def scenario(P):
        pool = P.pool.WorkerPool([DeadEngine()], evict_after=1, window=1.0,
                                 clock=FakeClock())
        f = pool.submit(3, block=False)
        pool.flush()
        assert isinstance(f.exception(), RuntimeError)
        assert pool.health() == [P.pool.EVICTED]
        with pytest.raises(P.dyn.Overloaded, match="evicted"):
            pool.submit(5, block=False)
        s = pool.stats()
        assert s["probes"] == 1 and s["probe_failures"] == 1
        pool.close()
        return fut(f), st(s)
    both(graph, scenario)


def test_close_drain_never_redispatches_onto_closing_workers(graph):
    def scenario(P):
        pool = P.pool.WorkerPool([P.runner(), DeadEngine()], evict_after=2,
                                 window=1.0, clock=FakeClock())
        ok = pool.workers[0].submit(3, block=False)
        doomed = [pool.workers[1].submit(r, block=False) for r in (5, 9)]
        pool.close(drain=True)
        assert ok.done() and ok.exception() is None
        for f in doomed:
            assert f.done() and isinstance(f.exception(), RuntimeError)
            assert not isinstance(f.exception(), P.dyn.BatcherClosed)
        assert "redispatches" not in pool.stats()
        return fut(ok), [fut(f) for f in doomed], st(pool.stats())
    both(graph, scenario)


def test_pool_health_constants_match(graph):
    assert tpool.HEALTH_STATES == jpool.HEALTH_STATES
    assert (tpool.HEALTHY, tpool.SUSPECT, tpool.EVICTED) == (
        jpool.HEALTHY, jpool.SUSPECT, jpool.EVICTED)


class EchoEngine:
    """A fast engine double: rows of the root's own id, no device."""

    num_vertices = N

    def run_batch(self, roots, **kw):
        roots = np.asarray(roots)
        return np.repeat(roots[:, None], 4, axis=1)


def test_threaded_pool_stress_counts_every_request():
    """More workers than cores, several submitting threads and a short
    switch interval: every future resolves with its own root's row and
    the pool's counters lose no update."""
    import os
    import sys
    import threading

    workers = min(16, (os.cpu_count() or 2) + 2)
    per_thread, threads = 150, 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = tpool.WorkerPool([EchoEngine() for _ in range(workers)],
                                window=0.001, max_batch=32, pipeline=True)
        futures = [[] for _ in range(threads)]

        def client(k):
            for i in range(per_thread):
                futures[k].append(pool.submit((k * per_thread + i) % N))

        ts = [threading.Thread(target=client, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
            assert not t.is_alive()
        pool.close(drain=True, timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    total = per_thread * threads
    got = [f for fs in futures for f in fs]
    assert len(got) == total
    for f in got:
        assert f.done() and (f.result(timeout=0) == f.root).all()
    s = pool.stats()
    assert s["requests"] == total and s["errors"] == 0
    assert sum(p["requests"] for p in s["per_worker"]) == total
