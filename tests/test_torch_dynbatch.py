"""The port's dynamic batcher (``repro_torch.launch.dynbatch``) against the
reference's (``repro.launch.dynbatch``).

Each case drives both packages' batchers with the same submits, the same
injected fake clock and engines over the same graph (the reference's
``LocalGraph`` carried across with ``interop.local_graph_from_numpy``), and
compares every future's row (bit for bit), error type, latency and SLO
verdict, every wave record (less its wall-clock seconds) and the stats
(less the busy and idle seconds and the TEPS read from them).  The
reference tests' own assertions (``tests/test_dynbatch.py``) run under
both, its ``DistributedBFS`` case too (the port's engine in a one-rank
gloo group).  The
real-clock threaded and pipelined cases compare rows only: their wave cuts
follow the wall clock.  ``serve_bfs_async`` closes the file.
"""
import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.ft as jft                                     # noqa: E402
import repro.launch.dynbatch as jdyn                       # noqa: E402
from repro.core import MultiSourceBFSRunner as JMS         # noqa: E402
from repro.core import bfs_oracle                          # noqa: E402
from repro.core import bitmap as jbitmap                   # noqa: E402
from repro.core import build_local_graph as j_build_local_graph  # noqa: E402
from repro.core import count_traversed_edges as j_count    # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro.graph import uniform_edges as j_uniform_edges   # noqa: E402
from repro.launch import serve as jserve                   # noqa: E402
from repro.compat import make_mesh as j_make_mesh          # noqa: E402
from repro.core import partition_graph as j_partition_graph  # noqa: E402
import repro.core.bfs_distributed as jbd                   # noqa: E402
import repro_torch.ft as tft                               # noqa: E402
import repro_torch.launch.dynbatch as tdyn                 # noqa: E402
from repro_torch.core import MultiSourceBFSRunner as TMS   # noqa: E402
from repro_torch.core import bitmap as tbitmap             # noqa: E402
from repro_torch.core import count_traversed_edges as t_count  # noqa: E402
from repro_torch.interop import local_graph_from_numpy     # noqa: E402
from repro_torch.launch import serve as tserve             # noqa: E402
from repro_torch.core import partition_graph as t_partition_graph  # noqa: E402
import repro_torch.core.bfs_distributed as tbd            # noqa: E402
from repro_torch.graph import csr_from_edges as t_csr_from_edges  # noqa: E402
from repro_torch.graph import transpose_csr as t_transpose_csr  # noqa: E402
from repro_torch.launch.mesh import make_mesh as t_make_mesh  # noqa: E402

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
    ref = SimpleNamespace(name="ref", dyn=jdyn, ft=jft, bitmap=jbitmap,
                          count=j_count, engine=lambda: JMS(jg))
    port = SimpleNamespace(name="port", dyn=tdyn, ft=tft, bitmap=tbitmap,
                           count=t_count, engine=lambda: TMS(tg))
    return SimpleNamespace(csr=csr, pkgs=(ref, port))


def both(graph, scenario):
    ref, port = graph.pkgs
    a, b = scenario(ref), scenario(port)
    assert a == b
    return b


def oracle(graph, r):
    return bfs_oracle(graph.csr, int(r))


def fut(f):
    """A future as both packages must agree on it."""
    exc = f.exception() if f.done() else None
    row = (np.asarray(f.result(timeout=0), np.int64).tobytes()
           if f.done() and exc is None else None)
    return (f.root, f.done(), row,
            None if exc is None else type(exc).__name__,
            None if exc is None or exc.__cause__ is None
            else type(exc.__cause__).__name__,
            f.latency, f.slo_miss)


def ws(w):
    """A wave record less its wall-clock service seconds and the port's own
    engine stamps (``t_dispatch``, ``t_engine_done``: the reference keeps
    none; ``test_torch_trace.py`` checks them); an error by its type only
    (the messages name each package's own text)."""
    if w is None:
        return None
    d = dataclasses.asdict(w)
    d.pop("seconds")
    d.pop("t_dispatch", None)
    d.pop("t_engine_done", None)
    d["error"] = None if w.error is None else w.error.split(":")[0]
    return d


def st(s):
    s = dict(s)
    for k in WALL_STATS:
        s.pop(k, None)
    ft = s.get("fault_tolerance")
    if ft is not None:
        ft = dict(ft)
        ft.pop("stragglers", None)
        ft.pop("wave_deadline", None)
        s["fault_tolerance"] = ft
    return s


# ---------------------------------------------------------------------------
# plane-slot pad/slice helpers (core)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,padded", [(1, 32), (5, 32), (31, 32), (32, 32),
                                      (33, 64), (48, 64), (64, 64)])
def test_pad_plane_slots(graph, b, padded):
    def scenario(P):
        roots = np.arange(1, b + 1, dtype=np.int64)
        slots, orig = P.bitmap.pad_plane_slots(roots)
        assert orig == b and slots.size == padded
        assert slots.dtype == roots.dtype
        rows = np.arange(padded * 3).reshape(padded, 3)
        np.testing.assert_array_equal(P.bitmap.slice_plane_rows(rows, orig),
                                      rows[:b])
        return slots.tolist(), orig
    both(graph, scenario)


def test_pad_plane_slots_rejects_empty(graph):
    for P in graph.pkgs:
        with pytest.raises(ValueError):
            P.bitmap.pad_plane_slots(np.asarray([], np.int64))


def test_pad_plane_slots_validates_fill(graph):
    def scenario(P):
        roots = np.asarray([4, 9, 2], np.int64)
        for bad, exc in ((1.5, TypeError), (True, TypeError),
                         ("0", TypeError), (-1, ValueError)):
            with pytest.raises(exc):
                P.bitmap.pad_plane_slots(roots, fill=bad)
        out = [P.bitmap.pad_plane_slots(roots, fill=np.int64(7)),
               P.bitmap.pad_plane_slots(roots, fill=0),
               P.bitmap.pad_plane_slots(np.arange(32, dtype=np.int64),
                                        fill=5)]
        return [(s.tolist(), b) for s, b in out]
    both(graph, scenario)


@pytest.mark.parametrize("b", [1, 31, 33])
def test_pad_slots_inert_in_wave_accounting(graph, b):
    roots = np.random.default_rng(100 + b).choice(N, b,
                                                  replace=False).tolist()

    def scenario(P):
        engine = P.engine()
        batcher = P.dyn.DynamicBatcher(engine, window=1.0, max_batch=64,
                                       clock=FakeClock())
        futures = [batcher.submit(int(r), block=False) for r in roots]
        waves = batcher.flush()
        assert len(waves) == 1
        w = waves[0]
        assert w.batch == b and w.n_slots == ((b + 31) // 32) * 32
        oracle_rows = np.stack([oracle(graph, r) for r in roots])
        for f, want in zip(futures, oracle_rows):
            np.testing.assert_array_equal(f.result(), want)
        assert w.traversed_edges == P.count(np.asarray(engine.out_deg),
                                            oracle_rows)
        res = engine.run(np.asarray(roots, np.int64))
        assert w.edges_inspected == res.edges_inspected
        return [fut(f) for f in futures], ws(w), st(batcher.stats())
    both(graph, scenario)


@pytest.mark.parametrize("b,slots", [(1, 32), (32, 32), (33, 64)])
def test_padded_slots_never_leak_into_results(graph, b, slots):
    roots = [int(r) for r in
             np.random.default_rng(b).choice(N, b, replace=False)]

    def scenario(P):
        batcher = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_batch=64,
                                       clock=FakeClock())
        futures = [batcher.submit(r, block=False) for r in roots]
        waves = batcher.flush()
        assert len(waves) == 1
        assert waves[0].batch == b and waves[0].n_slots == slots
        for f, r in zip(futures, roots):
            lv = np.asarray(f.result(timeout=0), np.int64)
            assert lv.shape == (N,)
            np.testing.assert_array_equal(lv, oracle(graph, r))
        assert batcher.stats()["requests"] == b
        batcher.close()
        return [fut(f) for f in futures], ws(waves[0])
    both(graph, scenario)


# ---------------------------------------------------------------------------
# deterministic fake-clock scheduling
# ---------------------------------------------------------------------------

def test_one_window_is_exactly_one_wave_matching_oracle(graph):
    roots = [0, 3, 17, 42, 199]

    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(P.engine(), window=0.01, max_batch=32,
                                 clock=clock)
        futures = []
        for r in roots:
            futures.append(b.submit(r, block=False))
            clock.advance(0.001)
        assert b.pump() is None
        assert not any(f.done() for f in futures)
        clock.advance(0.01)
        wave = b.pump()
        assert wave is not None and b.pump() is None
        assert len(b.waves) == 1 and wave.batch == len(roots)
        assert wave.n_slots == 32
        for f, r in zip(futures, roots):
            assert f.done() and f.wave is wave
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        assert futures[0].latency == pytest.approx(0.015)
        assert futures[-1].latency == pytest.approx(0.011)
        s = b.stats()
        assert s["waves"] == 1 and s["requests"] == 5
        assert s["traversed_edges"] == wave.traversed_edges > 0
        return [fut(f) for f in futures], ws(wave), st(s)
    both(graph, scenario)


def test_full_wave_dispatches_before_window(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=10.0, max_batch=4,
                                 clock=FakeClock(), pad_to_plane=False)
        for r in range(7):
            b.submit(r, block=False)
        wave = b.pump()
        assert wave.batch == 4 and wave.n_slots == 4
        assert b.pump() is None
        waves = b.flush()
        assert len(waves) == 1 and waves[0].batch == 3
        assert [w.wave_id for w in b.waves] == [0, 1]
        return [ws(w) for w in b.waves], st(b.stats())
    both(graph, scenario)


def test_window_restarts_from_oldest_remaining(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_batch=2,
                                 clock=clock)
        b.submit(1, block=False)
        clock.advance(0.5)
        b.submit(2, block=False)
        b.submit(3, block=False)
        got = [ws(b.pump()), ws(b.pump())]
        clock.advance(0.99)
        got.append(ws(b.pump()))
        clock.advance(0.02)
        got.append(ws(b.pump()))
        assert [g is None for g in got] == [False, True, True, False]
        assert got[0]["batch"] == 2 and got[3]["batch"] == 1
        return got
    both(graph, scenario)


def test_backpressure_bounded_queue(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_pending=3,
                                 clock=FakeClock())
        for r in range(3):
            b.submit(r, block=False)
        with pytest.raises(P.dyn.QueueFull):
            b.submit(3, block=False)
        with pytest.raises(P.dyn.QueueFull):
            b.submit(3)
        b.flush()
        f = b.submit(3, block=False)
        b.close(drain=True)
        return fut(f), st(b.stats())
    both(graph, scenario)


def test_close_drains_or_cancels(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=5.0, clock=FakeClock())
        f = b.submit(9, block=False)
        b.close(drain=True)
        np.testing.assert_array_equal(
            np.asarray(f.result(timeout=0), np.int64), oracle(graph, 9))
        with pytest.raises(P.dyn.BatcherClosed):
            b.submit(1, block=False)
        b2 = P.dyn.DynamicBatcher(P.engine(), window=5.0, clock=FakeClock())
        f2 = b2.submit(9, block=False)
        b2.close(drain=False)
        assert f2.done()
        with pytest.raises(P.dyn.BatcherClosed):
            f2.result(timeout=0)
        assert b2.stats()["waves"] == 0
        return fut(f), fut(f2), st(b.stats()), st(b2.stats())
    both(graph, scenario)


def test_submit_validates_roots(graph):
    def scenario(P):
        engine = P.engine()
        b = P.dyn.DynamicBatcher(engine, clock=FakeClock())
        assert P.dyn.engine_num_vertices(engine) == N
        for bad in (-1, N):
            with pytest.raises(ValueError):
                b.submit(bad, block=False)
        with pytest.raises(ValueError, match="integer"):
            b.submit(5.7, block=False)
        b.close()
        return b.stats()["waves"]
    both(graph, scenario)


def test_duplicate_roots_resolve_independently(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), clock=FakeClock())
        f1 = b.submit(5, block=False)
        f2 = b.submit(5, block=False)
        b.flush()
        for f in (f1, f2):
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, 5))
        return fut(f1), fut(f2)
    both(graph, scenario)


def test_wrapper_engine_bad_root_fails_only_its_future(graph):
    class Wrapper:
        def __init__(self, inner):
            self._inner = inner

        def run_batch(self, roots):
            return self._inner.run(np.asarray(roots)).levels

    def scenario(P):
        b = P.dyn.DynamicBatcher(Wrapper(P.engine()), window=1.0,
                                 clock=FakeClock())
        assert b.num_vertices is None and b.out_deg is None
        good = b.submit(3, block=False)
        bad = b.submit(999, block=False)
        good2 = b.submit(7, block=False)
        b.flush()
        with pytest.raises(ValueError):
            bad.result(timeout=0)
        for f, r in ((good, 3), (good2, 7)):
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        s = b.stats()
        assert s["errors"] >= 1 and "aggregate_teps" not in s
        b.close()
        return [fut(f) for f in (good, bad, good2)], [ws(w) for w in b.waves]
    both(graph, scenario)


# ---------------------------------------------------------------------------
# threaded real-clock mode
# ---------------------------------------------------------------------------

def test_threaded_serving_matches_oracle(graph):
    roots = [2, 50, 100, 150, 200, 250]

    def scenario(P):
        with P.dyn.DynamicBatcher(P.engine(), window=0.05) as b:
            futures = [b.submit(r) for r in roots]
            levels = [f.result(timeout=120.0) for f in futures]
        for lv, r in zip(levels, roots):
            np.testing.assert_array_equal(np.asarray(lv, np.int64),
                                          oracle(graph, r))
        s = b.stats()
        assert 1 <= s["waves"] <= len(roots) and s["requests"] == len(roots)
        assert s["latency_p99"] >= s["latency_p50"] > 0
        return [np.asarray(lv, np.int64).tobytes() for lv in levels]
    both(graph, scenario)


# ---------------------------------------------------------------------------
# fault tolerance: typed futures, drain under failure, supervised waves
# ---------------------------------------------------------------------------

class AlwaysDown:
    """Transiently-failing engine (every wave raises RuntimeError)."""

    last_stats = {}

    def run_batch(self, roots):
        raise RuntimeError("engine down")


def test_future_done_and_exception_accessors(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, clock=FakeClock())
        f = b.submit(5, block=False)
        assert not f.done() and f.exception() is None
        assert f.exception(timeout=0.01) is None
        b.flush()
        assert f.done() and f.exception() is None
        b.close()
        return fut(f)
    both(graph, scenario)


def test_failed_future_raises_typed_error_immediately(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(AlwaysDown(), window=1.0,
                                 clock=FakeClock())
        f = b.submit(3, block=False)
        b.flush()
        assert f.done() and isinstance(f.exception(), RuntimeError)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError):
            f.result(timeout=30.0)
        assert time.perf_counter() - t0 < 5.0
        b.close()
        return fut(f), st(b.stats())
    both(graph, scenario)


def test_drain_resolves_every_future_with_failing_engine_legacy(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(AlwaysDown(), window=1.0,
                                 clock=FakeClock())
        futures = [b.submit(r, block=False) for r in range(5)]
        b.close(drain=True)
        for f in futures:
            assert f.done() and isinstance(f.exception(), RuntimeError)
        s = b.stats()
        assert s["errors"] >= 1 and s["requests"] == 0
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_drain_resolves_every_future_with_failing_engine_supervised(graph):
    def scenario(P):
        sup = P.ft.EngineSupervisor(AlwaysDown(), max_retries=1, backoff=0.0,
                                    watchdog=False)
        b = P.dyn.DynamicBatcher(sup, window=1.0, clock=FakeClock())
        futures = [b.submit(r, block=False) for r in range(4)]
        b.close(drain=True)
        for f in futures:
            assert isinstance(f.exception(), P.ft.WaveAbandoned)
        s = b.stats()
        assert s["requests_failed"] == 4
        assert s["fault_tolerance"]["retries"] == 1
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_legacy_deterministic_fault_retries_singletons_once(graph):
    class BadRootEngine:
        last_stats = {}

        def __init__(self, inner):
            self._inner = inner

        def run_batch(self, roots):
            if 999 in np.asarray(roots).tolist():
                raise ValueError("root out of range")
            return self._inner.run(np.asarray(roots)).levels

    def scenario(P):
        b = P.dyn.DynamicBatcher(BadRootEngine(P.engine()), window=1.0,
                                 clock=FakeClock())
        good = b.submit(3, block=False)
        bad = b.submit(999, block=False)
        b.close(drain=True)
        with pytest.raises(ValueError):
            bad.result(timeout=0)
        np.testing.assert_array_equal(np.asarray(good.result(), np.int64),
                                      oracle(graph, 3))
        return fut(good), fut(bad), [ws(w) for w in b.waves]
    both(graph, scenario)


def test_supervised_wave_quarantines_poison_and_serves_rest(graph):
    roots = [0, 3, 42, 17, 99]

    def scenario(P):
        engine = P.engine()
        sup = P.ft.EngineSupervisor(
            P.ft.FaultyEngine(engine, poisoned_roots=[42]), backoff=0.0,
            watchdog=False)
        b = P.dyn.DynamicBatcher(sup, out_deg=np.asarray(engine.out_deg),
                                 window=1.0, clock=FakeClock())
        futures = [b.submit(r, block=False) for r in roots]
        waves = b.flush()
        assert len(waves) == 1
        assert waves[0].failed == 1 and waves[0].quarantined == [42]
        assert waves[0].traversals > 1
        for f, r in zip(futures, roots):
            if r == 42:
                assert isinstance(f.exception(), P.ft.RequestQuarantined)
                assert isinstance(f.exception().__cause__,
                                  P.ft.PoisonedRoot)
            else:
                np.testing.assert_array_equal(
                    np.asarray(f.result(), np.int64), oracle(graph, r))
        s = b.stats()
        assert s["requests"] == 4 and s["requests_failed"] == 1
        assert s["fault_tolerance"]["quarantined"] == [42]
        assert s["traversed_edges"] > 0
        b.close()
        return [fut(f) for f in futures], ws(waves[0]), st(s)
    both(graph, scenario)


# ---------------------------------------------------------------------------
# multi-word waves (max_batch spanning several plane words)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,slots", [(33, 64), (64, 64), (96, 96)])
def test_multiword_wave_pads_and_slices_without_leaks(graph, b, slots):
    rng = np.random.default_rng(1000 + b)
    roots = [int(r) for r in rng.choice(N, b, replace=(b > N))]

    def scenario(P):
        engine = P.engine()
        batcher = P.dyn.DynamicBatcher(engine, window=1.0, max_batch=96,
                                       clock=FakeClock())
        futures = [batcher.submit(r, block=False) for r in roots]
        waves = batcher.flush()
        assert len(waves) == 1
        assert waves[0].batch == b and waves[0].n_slots == slots
        oracle_rows = np.stack([oracle(graph, r) for r in roots])
        for f, want in zip(futures, oracle_rows):
            lv = np.asarray(f.result(timeout=0), np.int64)
            assert lv.shape == (N,)
            np.testing.assert_array_equal(lv, want)
        assert waves[0].traversed_edges == P.count(
            np.asarray(engine.out_deg), oracle_rows)
        batcher.close()
        return [fut(f) for f in futures], ws(waves[0])
    both(graph, scenario)


def test_supervised_multiword_bisection_keeps_future_order(graph):
    roots = list(range(64))

    def scenario(P):
        engine = P.engine()
        sup = P.ft.EngineSupervisor(
            P.ft.FaultyEngine(engine, poisoned_roots=[42]), backoff=0.0,
            watchdog=False)
        b = P.dyn.DynamicBatcher(sup, out_deg=np.asarray(engine.out_deg),
                                 window=1.0, max_batch=96, clock=FakeClock())
        futures = [b.submit(r, block=False) for r in roots]
        waves = b.flush()
        assert len(waves) == 1
        assert waves[0].batch == 64 and waves[0].n_slots == 64
        assert waves[0].failed == 1 and waves[0].quarantined == [42]
        for f, r in zip(futures, roots):
            if r == 42:
                assert isinstance(f.exception(), P.ft.RequestQuarantined)
            else:
                np.testing.assert_array_equal(
                    np.asarray(f.result(timeout=0), np.int64),
                    oracle(graph, r))
        b.close()
        return [fut(f) for f in futures], ws(waves[0])
    both(graph, scenario)


# ---------------------------------------------------------------------------
# accounting regressions
# ---------------------------------------------------------------------------

def test_failed_wave_latencies_reach_percentiles_legacy(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(AlwaysDown(), window=1.0, clock=clock)
        futures = [b.submit(r, block=False) for r in range(3)]
        clock.advance(2.0)
        b.flush()
        for f in futures:
            assert f.done() and f.latency == pytest.approx(2.0)
            assert f.wave is not None
        s = b.stats()
        assert s["errors"] == 1
        assert s["latency_p99"] == pytest.approx(2.0)
        assert s["latency_p50"] == pytest.approx(2.0)
        b.close()
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_failed_wave_latencies_reach_percentiles_supervised(graph):
    def scenario(P):
        clock = FakeClock()
        sup = P.ft.EngineSupervisor(AlwaysDown(), max_retries=0, backoff=0.0,
                                    watchdog=False)
        b = P.dyn.DynamicBatcher(sup, window=1.0, clock=clock)
        futures = [b.submit(r, block=False) for r in range(4)]
        clock.advance(3.0)
        b.flush()
        s = b.stats()
        assert s["requests_failed"] == 4
        assert s["latency_p99"] == pytest.approx(3.0)
        b.close()
        return [fut(f) for f in futures], st(s)
    both(graph, scenario)


def test_submit_timeout_runs_on_injected_clock(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(P.engine(), window=1e6, max_pending=1,
                                 clock=clock, start=True)
        b.submit(0, block=False)

        def expire():
            time.sleep(0.3)
            clock.advance(10.0)
            with b._cond:
                b._cond.notify_all()

        t = threading.Thread(target=expire, daemon=True)
        t.start()
        t0 = time.perf_counter()
        with pytest.raises(P.dyn.QueueFull):
            b.submit(1, timeout=5.0)
        assert time.perf_counter() - t0 < 4.0
        t.join()
        b.close(drain=True)
        return st(b.stats())
    both(graph, scenario)


def test_busy_seconds_accrue_for_failed_waves(graph):
    class SlowDown:
        last_stats = {}

        def run_batch(self, roots):
            time.sleep(0.02)
            raise RuntimeError("engine down")

    def scenario(P):
        b = P.dyn.DynamicBatcher(SlowDown(), out_deg=np.ones(N, np.int64),
                                 window=1.0, clock=FakeClock())
        for r in range(3):
            b.submit(r, block=False)
        b.flush()
        s = b.stats()
        assert s["errors"] == 1 and s["busy_seconds"] >= 0.02
        assert s["busy_seconds"] == pytest.approx(
            sum(w.seconds for w in b.waves), abs=1e-4)
        assert s["aggregate_teps"] == 0.0
        b.close()
        return st(s), s["aggregate_teps"]
    both(graph, scenario)


# ---------------------------------------------------------------------------
# SLO-aware cutting: deadlines, priorities, preemption, miss accounting
# ---------------------------------------------------------------------------

def test_submit_rejects_nonpositive_deadline(graph):
    for P in graph.pkgs:
        b = P.dyn.DynamicBatcher(P.engine(), clock=FakeClock())
        for d in (0.0, -1.0):
            with pytest.raises(ValueError):
                b.submit(1, block=False, deadline=d)
        b.close(drain=False)


def test_deadline_preempts_window(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(P.engine(), window=10.0, max_batch=32,
                                 clock=clock, slo_margin=0.5)
        f = b.submit(5, block=False, deadline=1.0)
        assert b.pump() is None
        clock.advance(0.6)
        w = b.pump()
        assert w is not None and w.preempted
        assert w.deadline_requests == 1 and w.slo_misses == 0
        assert f.slo_miss is False
        np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                      oracle(graph, 5))
        s = b.stats()
        assert s["slo_requests"] == 1 and s["slo_miss_rate"] == 0.0
        b.close()
        return fut(f), ws(w), st(s)
    both(graph, scenario)


def test_late_resolution_counts_as_slo_miss(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(P.engine(), window=0.1, clock=clock,
                                 slo_margin=0.0)
        f = b.submit(5, block=False, deadline=0.5)
        clock.advance(1.0)
        w = b.pump()
        assert w.deadline_requests == 1 and w.slo_misses == 1
        assert f.slo_miss is True and f.exception() is None
        s = b.stats()
        assert s["slo_misses"] == 1 and s["slo_miss_rate"] == 1.0
        b.close()
        return fut(f), ws(w), st(s)
    both(graph, scenario)


def test_failed_request_with_deadline_is_a_miss(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(AlwaysDown(), window=1.0,
                                 clock=FakeClock())
        f = b.submit(3, block=False, deadline=100.0)
        b.flush()
        assert isinstance(f.exception(), RuntimeError)
        assert f.slo_miss is True
        s = b.stats()
        assert s["slo_requests"] == 1 and s["slo_miss_rate"] == 1.0
        b.close()
        return fut(f), st(s)
    both(graph, scenario)


def test_wave_cut_orders_by_priority_then_deadline(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=100.0, max_batch=2,
                                 clock=FakeClock())
        f_plain = b.submit(1, block=False)
        f_loose = b.submit(2, block=False, deadline=5.0)
        f_tight = b.submit(3, block=False, deadline=1.0)
        w = b.pump()
        assert w.batch == 2
        assert f_tight.done() and f_loose.done() and not f_plain.done()
        b.flush()
        for f, r in ((f_plain, 1), (f_loose, 2), (f_tight, 3)):
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        b.close()
        return [fut(f) for f in (f_plain, f_loose, f_tight)], ws(w)
    both(graph, scenario)


def test_priority_beats_deadline_in_cut_order(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=100.0, max_batch=1,
                                 clock=FakeClock())
        f_dl = b.submit(1, block=False, deadline=0.5)
        f_hi = b.submit(2, block=False, priority=-1)
        w = b.pump()
        assert w.batch == 1 and f_hi.done() and not f_dl.done()
        b.close(drain=True)
        return fut(f_hi), fut(f_dl)
    both(graph, scenario)


# ---------------------------------------------------------------------------
# pipelined mode (cutter / dispatcher / finisher stages)
# ---------------------------------------------------------------------------

def test_pipeline_requires_threaded_mode(graph):
    for P in graph.pkgs:
        with pytest.raises(ValueError):
            P.dyn.DynamicBatcher(P.engine(), clock=FakeClock(),
                                 pipeline=True)


def test_pipelined_serving_matches_oracle(graph):
    roots = [2, 50, 100, 150, 200, 250, 33, 77]

    def scenario(P):
        with P.dyn.DynamicBatcher(P.engine(), window=0.02, max_batch=64,
                                  pipeline=True) as b:
            futures = [b.submit(r) for r in roots]
            levels = [f.result(timeout=120.0) for f in futures]
        for lv, r in zip(levels, roots):
            np.testing.assert_array_equal(np.asarray(lv, np.int64),
                                          oracle(graph, r))
        s = b.stats()
        assert s["pipeline"] is True and s["requests"] == len(roots)
        assert s["engine_idle_seconds"] >= 0.0
        assert s["latency_p999"] >= s["latency_p99"] >= s["latency_p50"]
        return [np.asarray(lv, np.int64).tobytes() for lv in levels]
    both(graph, scenario)


def test_pipelined_supervised_chaos_resolves_everything(graph):
    roots = [3, 42, 17, 99]

    def scenario(P):
        engine = P.engine()
        sup = P.ft.EngineSupervisor(
            P.ft.FaultyEngine(engine, poisoned_roots=[42]), backoff=0.0,
            watchdog=False)
        with P.dyn.DynamicBatcher(sup, out_deg=np.asarray(engine.out_deg),
                                  window=0.02, max_batch=64,
                                  pipeline=True) as b:
            futures = [b.submit(r) for r in roots]
            for f in futures:
                f.exception(timeout=120.0)
        out = []
        for f, r in zip(futures, roots):
            if r == 42:
                assert isinstance(f.exception(), P.ft.RequestQuarantined)
                out.append(type(f.exception()).__name__)
            else:
                lv = np.asarray(f.result(timeout=0), np.int64)
                np.testing.assert_array_equal(lv, oracle(graph, r))
                out.append(lv.tobytes())
        assert b.stats()["requests_failed"] == 1
        return out
    both(graph, scenario)


# ---------------------------------------------------------------------------
# admission control (shed), health streaks, pool-support plumbing
# ---------------------------------------------------------------------------

class TimedEngine:
    """Wraps a runner, charging a fixed fake-clock cost per wave so the
    batcher's EWMA service estimate is deterministic."""

    def __init__(self, inner, clock, cost=0.2, fails_left=0):
        self.inner = inner
        self.clock = clock
        self.cost = float(cost)
        self.fails_left = int(fails_left)
        self.num_vertices = inner.num_vertices

    def run_batch(self, roots, **kw):
        self.clock.advance(self.cost)
        if self.fails_left > 0:
            self.fails_left -= 1
            raise RuntimeError("injected engine failure")
        return self.inner.run_batch(roots, **kw)


def test_service_hint_primes_estimated_delay(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_batch=4,
                                 clock=FakeClock(), service_hint=1.0)
        got = [b.estimated_delay()]
        b.submit(3, block=False)
        b.submit(5, block=False)
        got.append(b.estimated_delay())
        assert got == [pytest.approx(1.0), pytest.approx(1.5)]
        b.flush()
        got.append(b.estimated_delay())
        b.close()
        with pytest.raises(ValueError):
            P.dyn.DynamicBatcher(P.engine(), clock=FakeClock(),
                                 service_hint=-0.5)
        return got
    both(graph, scenario)


def test_ewma_tracks_measured_wave_service(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(TimedEngine(P.engine(), clock, cost=0.2),
                                 window=1.0, clock=clock)
        cold = b.estimated_delay()
        assert cold == 0.0
        b.submit(3, block=False)
        b.flush()
        assert b.estimated_delay() == pytest.approx(0.2)
        b.close()
        return cold, b.estimated_delay()
    both(graph, scenario)


def test_shed_rejects_doomed_deadline_with_typed_overloaded(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_batch=4,
                                 clock=FakeClock(), shed=True,
                                 service_hint=1.0)
        ok = b.submit(3, block=False, deadline=10.0)
        with pytest.raises(P.dyn.Overloaded):
            b.submit(5, block=False, deadline=0.4)
        plain = b.submit(7, block=False)
        b.flush()
        assert ok.exception() is None
        s = b.stats()
        assert s["shed"] == 1 and s["requests"] == 2
        b.close()
        return fut(ok), fut(plain), st(s)
    both(graph, scenario)


def test_shed_off_queues_doomed_deadline(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, clock=FakeClock(),
                                 service_hint=5.0)
        f = b.submit(3, block=False, deadline=0.01)
        b.flush()
        assert f.done() and "shed" not in b.stats()
        b.close()
        return fut(f)
    both(graph, scenario)


def test_cancel_pending_pops_without_resolving(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, clock=FakeClock())
        futs = [b.submit(r, block=False, deadline=5.0) for r in (3, 5, 9)]
        popped = b.cancel_pending()
        assert popped == futs and b.backlog() == 0
        assert not any(f.done() for f in popped)
        assert b.flush() == []
        b2 = P.dyn.DynamicBatcher(P.engine(), window=1.0, clock=FakeClock())
        for f in popped:
            b2._submit_future(f)
        b2.flush()
        for f, r in zip(popped, (3, 5, 9)):
            assert f.t_deadline == 5.0
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          oracle(graph, r))
        b.close()
        b2.close()
        return [fut(f) for f in popped], st(b2.stats())
    both(graph, scenario)


def test_submit_future_respects_capacity_and_close(graph):
    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), window=1.0, max_pending=1,
                                 clock=FakeClock())
        f = b.submit(3, block=False)
        b.cancel_pending()
        b.submit(5, block=False)
        with pytest.raises(P.dyn.QueueFull):
            b._submit_future(f)
        b.flush()
        b.close()
        with pytest.raises(P.dyn.BatcherClosed):
            b._submit_future(f)
        return fut(f), st(b.stats())
    both(graph, scenario)


def test_consecutive_failures_streak_resets_on_success(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(TimedEngine(P.engine(), clock,
                                             fails_left=2),
                                 window=1.0, clock=clock)
        streak = []
        for _ in range(3):
            b.submit(3, block=False)
            b.flush()
            streak.append(b.consecutive_failures)
        assert streak == [1, 2, 0]
        assert "consecutive_failures" not in b.stats()
        b.close()
        return streak, st(b.stats())
    both(graph, scenario)


def test_failure_handler_takes_ownership_of_failing_futures(graph):
    def scenario(P):
        clock = FakeClock()
        handled = []

        def handler(f, exc):
            handled.append((f, exc))
            return len(handled) == 1

        b = P.dyn.DynamicBatcher(TimedEngine(P.engine(), clock,
                                             fails_left=2),
                                 window=1.0, clock=clock,
                                 failure_handler=handler)
        f1 = b.submit(3, block=False)
        b.flush()
        assert not f1.done()
        f2 = b.submit(5, block=False)
        b.flush()
        assert f2.done() and isinstance(f2.exception(), RuntimeError)
        assert [f for f, _ in handled] == [f1, f2]
        assert b.consecutive_failures == 2
        assert b.stats()["requests_failed"] == 1
        f1._fail(RuntimeError("resolved by the test, standing in for a "
                              "pool"))
        b.close()
        return fut(f1), fut(f2), st(b.stats())
    both(graph, scenario)


def test_failure_handler_exception_is_contained(graph):
    def scenario(P):
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(TimedEngine(P.engine(), clock,
                                             fails_left=1),
                                 window=1.0, clock=clock,
                                 failure_handler=lambda f, e: 1 / 0)
        f = b.submit(3, block=False)
        b.flush()
        assert f.done() and isinstance(f.exception(), RuntimeError)
        b.close()
        return fut(f)
    both(graph, scenario)


# ---------------------------------------------------------------------------
# wave sizes, the open-loop driver, serve_bfs_async
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 32, 33, 96])
def test_plane_wave_sizes(graph, max_batch):
    def scenario(P):
        return P.dyn.plane_wave_sizes(max_batch)
    both(graph, scenario)


def test_drive_open_loop_closed_and_poisson(graph):
    """Back-to-back and Poisson arrivals: every admitted future resolves
    with the oracle's row."""
    roots = np.asarray([4, 8, 15, 16, 23, 42], np.int64)

    def scenario(P):
        out = []
        for rate in (None, 400.0):
            b = P.dyn.DynamicBatcher(P.engine(), window=0.01, max_batch=32)
            futures = P.dyn.drive_open_loop(
                b, roots, rate=rate, rng=np.random.default_rng(3))
            for f, r in zip(futures, roots):
                np.testing.assert_array_equal(
                    np.asarray(f.result(timeout=0), np.int64),
                    oracle(graph, r))
            out.append([np.asarray(f.result(timeout=0), np.int64).tobytes()
                        for f in futures])
        return out
    both(graph, scenario)


def test_distributed_engine_behind_batcher(tmp_path):
    """The reference's case: a ``DistributedBFS`` of 4 PEs on a one-device
    mesh behind the batcher (the port's in a one-rank gloo group)."""
    import torch.distributed as dist
    src, dst = j_uniform_edges(64, 256, seed=3)
    jcsr = j_csr_from_edges(src, dst, 64)
    tcsr = t_csr_from_edges(src, dst, 64)
    deg = np.diff(jcsr.indptr)
    roots = [0, 13, 63]

    def scenario(P):
        b = P.dyn.DynamicBatcher(P.engine(), out_deg=deg, window=0.01,
                                 clock=FakeClock())
        futures = [b.submit(r, block=False) for r in roots]
        waves = b.flush()
        assert len(waves) == 1 and waves[0].n_slots == 32
        assert waves[0].traversed_edges > 0
        for f, r in zip(futures, roots):
            np.testing.assert_array_equal(np.asarray(f.result(), np.int64),
                                          bfs_oracle(jcsr, r))
        b.close()
        return [fut(f) for f in futures], ws(waves[0])

    ref = SimpleNamespace(dyn=jdyn, engine=lambda: jbd.DistributedBFS(
        j_partition_graph(jcsr, j_transpose_csr(jcsr), 4),
        j_make_mesh((1,), ("data",)), cfg=jbd.DistConfig(dispatch="bitmap")))
    port = SimpleNamespace(dyn=tdyn, engine=lambda: tbd.DistributedBFS(
        t_partition_graph(tcsr, t_transpose_csr(tcsr), 4),
        t_make_mesh((1,), ("data",), device="cpu"),
        cfg=tbd.DistConfig(dispatch="bitmap")))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        assert scenario(ref) == scenario(port)
    finally:
        dist.destroy_process_group()


def test_serve_bfs_async_matches_reference():
    """The serving entry on a generated graph, supervised with the audit
    tier and pipelined: the same requests, no faults, the same integrity
    counters; ``keep_levels`` rows equal a pre-batched wave's."""
    kw = dict(requests=48, window=0.02, max_batch=32, seed=3,
              pipeline=True, ft_max_retries=2, ft_integrity="audit",
              ft_audit_rate=0.5)
    ref = jserve.serve_bfs_async("small-12-8", **kw)
    port = tserve.serve_bfs_async("small-12-8", device="cpu",
                                  keep_levels=True, **kw)
    for out in (ref, port):
        assert out["errors"] == 0 and out["requests"] == 48
        ft = out["fault_tolerance"]
        assert ft["retries"] == ft["timeouts"] == 0
        assert ft["quarantined"] == [] and ft["demotions"] == []
        assert out["integrity"]["audit_failures"] == 0
        assert out["integrity"]["checks"] == out["waves"]
    assert port["roots"].size == 48 and port["levels"].shape[0] == 48
    assert port["stream_seconds"] > 0
    rng = np.random.default_rng(3)
    want_roots = rng.choice(np.flatnonzero(np.diff(
        tserve.get_dataset("small-12-8").csr.indptr) > 0), 48, replace=True)
    np.testing.assert_array_equal(port["roots"], want_roots)
    engine, deg = tserve.build_engine("small-12-8", device="cpu")
    for lo in range(0, 48, 16):
        np.testing.assert_array_equal(
            port["levels"][lo:lo + 16],
            engine.run_batch(port["roots"][lo:lo + 16]))


def test_serve_bfs_async_pool_of_two_workers():
    """``workers=2``: a WorkerPool over two runners sharing one graph, each
    supervised; every request served, both packages alike."""
    kw = dict(requests=40, window=0.01, max_batch=32, seed=5, workers=2,
              ft_max_retries=1, ft_integrity="witness")
    ref = jserve.serve_bfs_async("small-12-8", **kw)
    port = tserve.serve_bfs_async("small-12-8", device="cpu",
                                  keep_levels=True, **kw)
    for out in (ref, port):
        assert out["workers"] == 2 and out["errors"] == 0
        assert out["requests"] == 40 and len(out["fault_tolerance"]) == 2
        assert out["integrity"]["violations"] == 0
        assert out["integrity"]["mode"] == "witness"
    engine, _ = tserve.build_engine("small-12-8", device="cpu")
    np.testing.assert_array_equal(port["levels"],
                                  engine.run_batch(port["roots"]))
    with pytest.raises(ValueError):
        tserve.serve_bfs_async("small-12-8", workers=0, device="cpu")


def test_serve_bfs_async_takes_the_reference_parameters():
    """The port's serving entry takes the reference's parameters with the
    reference's defaults, in its order, plus only where the graph lives
    (``device``) and whether the served rows come back (``keep_levels``)."""
    import inspect
    ref = inspect.signature(jserve.serve_bfs_async).parameters
    port = inspect.signature(tserve.serve_bfs_async).parameters
    assert list(port)[:len(ref)] == list(ref)
    assert set(port) - set(ref) == {"device", "keep_levels"}
    for name, p in ref.items():
        assert port[name].default == p.default, name


@pytest.mark.parametrize("b", [1, 32, 40])
def test_packed_wave_rows_arrive_contiguous(graph, b):
    """A packed wave's value rows come back transposed on the device: each
    row is contiguous (the batcher's per-request copy is one memcpy), and
    the rows equal the reference's bit for bit."""
    ref, port = graph.pkgs
    roots = np.random.default_rng(b).choice(N, b, replace=False)
    want = np.asarray(ref.engine().run_batch(roots))
    got = port.engine().run_batch(roots)
    assert got.shape == (b, N) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_cli_async_prints_one_json_line(capsys):
    import json
    tserve.main(["--bfs-graph", "small-12-8", "--bfs-serve-async",
                 "--bfs-requests", "16", "--bfs-max-batch", "32",
                 "--ft-integrity", "invariants", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["requests"] == 16 and out["errors"] == 0
    assert out["integrity"]["mode"] == "invariants"
