"""Chaos acceptance of the port's serving stack against the reference's,
on a real graph.

Both packages serve the same requests over the same graph (the reference's
``LocalGraph`` carried across with ``interop.local_graph_from_numpy``)
through a fake-clock ``DynamicBatcher`` in front of ``EngineSupervisor``
over ``FaultyEngine`` and the real MS-BFS runner, with the same
``FaultPlan``.  Every case compares, between the packages: every served row
(bit for bit), every failed request's error type, the quarantined roots,
the supervisor's counters, the demotion labels and the injected faults.
The reference tests' own assertions (``tests/test_chaos.py`` and the
supervisor cases of ``tests/test_integrity.py``) run under both.

``test_card_chaos_schedule`` runs on the CPU the fault schedule that
``chip_smoke.py`` (q) runs on the card.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.ft as jft                                     # noqa: E402
import repro.launch.dynbatch as jdyn                       # noqa: E402
from repro.core import MultiSourceBFSRunner as JMS         # noqa: E402
from repro.core import bfs_oracle as j_bfs_oracle          # noqa: E402
from repro.core import build_local_graph as j_build_local_graph  # noqa: E402
from repro.graph import csr_from_edges as j_csr_from_edges  # noqa: E402
from repro.graph import transpose_csr as j_transpose_csr   # noqa: E402
from repro.graph import uniform_edges as j_uniform_edges   # noqa: E402
import repro_torch.ft as tft                               # noqa: E402
import repro_torch.launch.dynbatch as tdyn                 # noqa: E402
from repro_torch.core import MultiSourceBFSRunner as TMS   # noqa: E402
from repro_torch.core.bfs_local import INF                 # noqa: E402
from repro_torch.interop import local_graph_from_numpy     # noqa: E402

N = 256
B = 32                   # wave width = one plane word
REQUESTS = 3 * B
LABELS = {"pallas->jnp": "kernels->torch"}
WALL_KEYS = ("stragglers",)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def chaos_roots(deg):
    """The 128 requests of ``test_card_chaos_schedule``."""
    rng = np.random.default_rng(1)
    return rng.choice(np.flatnonzero(deg > 0), 128).astype(np.int64)


@pytest.fixture(scope="module")
def served():
    """Both packages' runners over one graph, the request stream, a
    poisoned root and the fault-free rows (the reference's)."""
    src, dst = j_uniform_edges(N, 1024, seed=7)
    csr = j_csr_from_edges(src, dst, N)
    jg = j_build_local_graph(csr, j_transpose_csr(csr))
    fields = {f.name: np.asarray(getattr(jg, f.name))
              for f in dataclasses.fields(jg) if f.name not in ("n", "n_pad")}
    tg = local_graph_from_numpy(fields, jg.n, jg.n_pad, device="cpu")
    deg = np.diff(csr.indptr)
    rng = np.random.default_rng(0)
    reachable = np.flatnonzero(deg > 0)
    roots = rng.choice(reachable, REQUESTS, replace=True).astype(np.int64)
    poison = int(np.setdiff1d(reachable, roots)[0])
    roots[B + B // 2] = poison
    ref = {}
    jr = JMS(jg)
    for lo in range(0, REQUESTS, B):
        wave = np.resize(roots[lo:lo + B], B)
        for r, row in zip(wave, jr.run(wave).levels):
            ref[int(r)] = np.asarray(row, np.int64).copy()
    ref[poison] = np.asarray(jr.run(np.asarray([poison])).levels[0],
                             np.int64)
    ref_pkg = SimpleNamespace(name="ref", ft=jft, dyn=jdyn,
                              runner=lambda **kw: JMS(jg, **kw),
                              knob="use_pallas", breaker="break_pallas")
    port_pkg = SimpleNamespace(name="port", ft=tft, dyn=tdyn,
                               runner=lambda **kw: TMS(tg, **kw),
                               knob="use_kernels", breaker="break_kernels")
    # warm both engines on every wave so no budget is first met mid-test:
    # the packed runner with and without the witness check and the
    # bool-plane rung a demotion lands on, over these roots and over
    # test_card_chaos_schedule's; the reference compiles each (program,
    # budget, check) step on its first wave, which past its 0.5 s wave
    # deadline would count as a second timeout
    for pkg in (ref_pkg, port_pkg):
        for kw in ({}, {"integrity": "witness"}, {"packed": False}):
            r = pkg.runner(**kw)
            for wave_roots in (roots, chaos_roots(deg)):
                for lo in range(0, len(wave_roots), B):
                    r.run(np.resize(wave_roots[lo:lo + B], B))
    return dict(csr=csr, deg=deg, roots=roots, poison=poison, ref=ref,
                pkgs=(ref_pkg, port_pkg))


def both(served, scenario):
    ref_pkg, port_pkg = served["pkgs"]
    a, b = scenario(ref_pkg), scenario(port_pkg)
    assert a == b
    return b


def outcome_of(f):
    exc = f.exception()
    if exc is None:
        return (f.root, np.asarray(f.result(), np.int64).tobytes(), None,
                None)
    return (f.root, None, type(exc).__name__,
            None if exc.__cause__ is None else type(exc.__cause__).__name__)


def sup_stats(sup):
    s = dict(sup.stats())
    s["demotions"] = [LABELS.get(d, d) for d in s["demotions"]]
    for k in WALL_KEYS:
        s.pop(k, None)
    if sup.wave_deadline is None:
        s.pop("wave_deadline", None)
    return s


def wave_outcomes(wave):
    return [(o.root,
             None if o.levels is None
             else np.asarray(o.levels, np.int64).tobytes(),
             None if o.error is None else type(o.error).__name__)
            for o in wave.outcomes]


def ws_summary(ws):
    return dict(batch=ws.batch, n_slots=ws.n_slots,
                iterations=ws.iterations, failed=ws.failed,
                traversals=ws.traversals, retries=ws.retries,
                timeouts=ws.timeouts, quarantined=list(ws.quarantined),
                demotions=[LABELS.get(d, d) for d in ws.demotions],
                traversed_edges=ws.traversed_edges,
                error=None if ws.error is None else ws.error.split(":")[0])


def join_zombie(sup):
    z = sup._zombie
    if z is not None:
        z.join(30.0)


# ---------------------------------------------------------------------------
# the reference's chaos acceptance, both packages
# ---------------------------------------------------------------------------

def test_chaos_stream_resolves_everything_correctly(served):
    """96 requests under kernel fault + stuck wave + poisoned root."""
    roots, poison, ref = served["roots"], served["poison"], served["ref"]

    def scenario(P):
        chaos = P.ft.FaultyEngine(P.runner(), P.ft.FaultPlan(),
                                  poisoned_roots=[poison],
                                  stall_seconds=1.2)
        sup = P.ft.EngineSupervisor(chaos, max_retries=3, backoff=0.01,
                                    wave_deadline=0.4, degrade=False,
                                    jitter=False)
        b = P.dyn.DynamicBatcher(sup, out_deg=served["deg"], window=1.0,
                                 max_batch=B, clock=FakeClock())
        futures = []
        chaos.plan = P.ft.FaultPlan([(chaos.calls, "kernel")])
        futures += [b.submit(int(r), block=False) for r in roots[:B]]
        assert len(b.flush()) == 1
        futures += [b.submit(int(r), block=False) for r in roots[B:2 * B]]
        assert len(b.flush()) == 1
        chaos.plan = P.ft.FaultPlan([(chaos.calls, "stuck")])
        futures += [b.submit(int(r), block=False) for r in roots[2 * B:]]
        assert len(b.flush()) == 1
        b.close()
        join_zombie(sup)
        assert all(f.done() for f in futures)
        for f, r in zip(futures, roots.tolist()):
            exc = f.exception()
            if int(r) == poison:
                assert isinstance(exc, P.ft.RequestQuarantined)
            else:
                assert exc is None, f"clean root {r} failed: {exc!r}"
                np.testing.assert_array_equal(
                    np.asarray(f.result(), np.int64), ref[int(r)])
        s = b.stats()
        assert s["requests"] == REQUESTS - 1 and s["requests_failed"] == 1
        ft = s["fault_tolerance"]
        assert ft["quarantined"] == [poison] and ft["timeouts"] >= 1
        assert ft["retries"] >= 2 and chaos.plan.pending() == {}
        assert ft["fault_waves"] <= (1 + ft["timeouts"]
                                     + math.ceil(math.log2(B)) + 1)
        stuck_wave = list(b.waves)[-1]
        assert stuck_wave.timeouts >= 1 and stuck_wave.failed == 0
        return ([outcome_of(f) for f in futures], sup_stats(sup),
                [ws_summary(w) for w in b.waves])
    both(served, scenario)


def test_bisection_bound_on_real_wave(served):
    poison, ref = served["poison"], served["ref"]
    clean = np.asarray([r for r in sorted(ref) if r != poison], np.int64)
    wave_roots = np.resize(clean, B)
    wave_roots[B // 2] = poison

    def scenario(P):
        sup = P.ft.EngineSupervisor(
            P.ft.FaultyEngine(P.runner(), poisoned_roots=[poison]),
            watchdog=False, backoff=0.0)
        wave = sup.run_wave(wave_roots)
        assert wave.fault_waves == math.ceil(math.log2(B)) + 1
        assert wave.quarantined == [poison] and wave.n_ok == B - 1
        for o in wave.outcomes:
            if o.root != poison:
                np.testing.assert_array_equal(
                    np.asarray(o.levels, np.int64), ref[o.root])
        return wave_outcomes(wave), sup_stats(sup)
    both(served, scenario)


def test_forced_kernel_failure_demotes_to_torch_matching_reference(served):
    """break_kernels (the reference's break_pallas): the ladder turns the
    kernels off mid-wave (a CPU runner) and the plain path's rows equal
    the fault-free rows."""
    poison, ref = served["poison"], served["ref"]
    clean = np.asarray([r for r in sorted(ref) if r != poison],
                       np.int64)[:B]

    def scenario(P):
        runner = P.runner(**{P.knob: True})
        sup = P.ft.EngineSupervisor(
            P.ft.FaultyEngine(runner, **{P.breaker: True}), max_retries=3,
            backoff=0.0, watchdog=False)
        wave = sup.run_wave(clean)
        assert getattr(runner, P.knob) is True       # restored after
        assert wave.n_failed == 0
        for o in wave.outcomes:
            np.testing.assert_array_equal(np.asarray(o.levels, np.int64),
                                          ref[o.root])
        return wave_outcomes(wave), sup_stats(sup)
    assert both(served, scenario)[1]["demotions"] == ["kernels->torch"]


def test_watchdog_deadline_tracks_timer_on_real_waves(served):
    roots = np.resize(np.asarray(sorted(served["ref"])[:5], np.int64), B)

    def scenario(P):
        sup = P.ft.EngineSupervisor(P.runner(), watchdog=True)
        cold = sup.current_deadline()
        rows = [wave_outcomes(sup.run_wave(roots)) for _ in range(3)]
        dl, med = sup.current_deadline(), sup.timer.median()
        assert dl is not None and med is not None
        assert (dl >= sup.timer.k * med
                or dl == pytest.approx(sup.min_deadline))
        return cold, rows
    assert both(served, scenario)[0] is None


# ---------------------------------------------------------------------------
# integrity under the supervisor (the reference's test_integrity cases)
# ---------------------------------------------------------------------------

def _far_vertex(csr, root: int) -> int:
    lv = j_bfs_oracle(csr, root)
    far = np.flatnonzero((lv >= 3) | (lv == INF))
    assert far.size, "graph too dense for a far vertex"
    return int(far[0])


@pytest.mark.parametrize("kind", ["plane_flip", "result_flip"])
def test_supervisor_detects_and_recovers_bit_flip(served, kind):
    csr, ref = served["csr"], served["ref"]
    roots = np.asarray(sorted(ref)[:B], np.int64)
    far = _far_vertex(csr, int(roots[0]))
    spec = {"plane_flip": dict(plane_flip=(1, far, 0)),
            "result_flip": dict(result_flip=(0, far, 16))}[kind]

    def scenario(P):
        chaos = P.ft.FaultyEngine(P.runner(), P.ft.FaultPlan([(0, kind)]),
                                  **spec)
        sup = P.ft.EngineSupervisor(chaos, watchdog=False, backoff=0.0,
                                    integrity=P.ft.IntegrityConfig(
                                        mode="witness"))
        wave = sup.run_wave(roots)
        assert len(chaos.flips) == 1 and chaos.flips[0]["kind"] == kind
        assert wave.n_failed == 0
        st = sup.stats()
        assert st["integrity"]["violations"] >= 1 and st["retries"] >= 1
        for o in wave.outcomes:
            np.testing.assert_array_equal(np.asarray(o.levels, np.int64),
                                          j_bfs_oracle(csr, o.root))
        return wave_outcomes(wave), sup_stats(sup), chaos.flips
    both(served, scenario)


def test_audit_tier_samples_clean_waves(served):
    roots = np.asarray(sorted(served["ref"])[:B], np.int64)

    def scenario(P):
        sup = P.ft.EngineSupervisor(P.runner(), watchdog=False, backoff=0.0,
                                    integrity=P.ft.IntegrityConfig(
                                        mode="audit", audit_rate=1.0))
        wave = sup.run_wave(roots)
        assert wave.n_failed == 0
        st = sup.stats()["integrity"]
        assert st["audits"] == 1 and st["audit_failures"] == 0
        assert st["violations"] == 0
        assert sup._tunable.packed is True           # restored after
        return wave_outcomes(wave), sup_stats(sup)
    both(served, scenario)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_audit_rate_samples_the_same_waves(served, rate):
    """The audit draws from ``IntegrityConfig.seed``: both packages audit
    the same waves of a run."""
    roots = np.asarray(sorted(served["ref"])[:B], np.int64)

    def scenario(P):
        sup = P.ft.EngineSupervisor(P.runner(), watchdog=False, backoff=0.0,
                                    integrity=P.ft.IntegrityConfig(
                                        mode="audit", audit_rate=rate))
        audits = []
        for _ in range(6):
            assert sup.run_wave(roots).n_failed == 0
            audits.append(sup.stats()["integrity"]["audits"])
        if rate == 0.0:
            assert audits[-1] == 0
        return audits, sup_stats(sup)
    both(served, scenario)


def test_audit_flags_rows_that_differ_from_the_reference_rung(served):
    """A packed engine whose rows differ from its bool-plane rung fails
    the audit in both packages."""
    roots = np.asarray(sorted(served["ref"])[:B], np.int64)

    def scenario(P):
        runner = P.runner()
        plain_run_batch = runner.run_batch

        def skewed(r, **kw):
            rows = np.array(plain_run_batch(r, **kw))
            if runner.packed:            # only the served rung is wrong
                rows[1, rows[1] == 2] = 3
            return rows

        runner.run_batch = skewed
        sup = P.ft.EngineSupervisor(runner, watchdog=False, backoff=0.0,
                                    max_retries=1, degrade=False,
                                    integrity=P.ft.IntegrityConfig(
                                        mode="audit", audit_rate=1.0))
        wave = sup.run_wave(roots)
        st = sup.stats()["integrity"]
        assert st["audit_failures"] >= 1 and wave.n_failed == B
        return wave_outcomes(wave), sup_stats(sup)
    both(served, scenario)


# ---------------------------------------------------------------------------
# chip_smoke.py (q)'s schedule, on the CPU, both packages
# ---------------------------------------------------------------------------

def test_card_chaos_schedule(served):
    """Two kernel faults in one wave (a demotion), an out-of-range root
    quarantined by bisection with a runtime fault on a clean half, a stuck
    wave under an explicit deadline, a plane flip and a result flip: 128
    requests in five waves, every one resolved with a row or a typed
    error, neither flip served."""
    csr, deg = served["csr"], served["deg"]
    roots = chaos_roots(deg)
    bad = N + 5
    far = _far_vertex(csr, int(roots[96]))
    waves = [(0, 32), (32, 64), (64, 96), (96, 112), (112, 128)]
    plan = [(0, "kernel"), (1, "kernel"), (13, "runtime"), (15, "stuck"),
            (17, "plane_flip"), (19, "result_flip")]

    def scenario(P):
        runner = P.runner()
        chaos = P.ft.FaultyEngine(runner, P.ft.FaultPlan(plan),
                                  plane_flip=(1, far, 0),
                                  result_flip=(0, 0, 16), stall_seconds=1.0)
        sup = P.ft.EngineSupervisor(chaos, integrity="witness",
                                    wave_deadline=0.5, max_retries=3,
                                    backoff=0.0)
        clock = FakeClock()
        b = P.dyn.DynamicBatcher(sup, out_deg=deg, window=1.0, max_batch=B,
                                 clock=clock)
        futures = []
        for w, (lo, hi) in enumerate(waves):
            if w == 1:     # past submit()'s check, as a redispatch would be
                f = P.dyn.BFSFuture(bad, clock())
                b._submit_future(f)
                futures.append(f)
                lo += 1
            futures += [b.submit(int(r), block=False) for r in roots[lo:hi]]
            assert len(b.flush()) == 1
            join_zombie(sup)
        b.close()
        assert chaos.plan.pending() == {}
        for f in futures:
            exc = f.exception()
            if f.root == bad:
                assert isinstance(exc, P.ft.RequestQuarantined)
                assert isinstance(exc.__cause__, ValueError)
            else:
                assert exc is None, f"root {f.root}: {exc!r}"
                np.testing.assert_array_equal(
                    np.asarray(f.result(), np.int64),
                    j_bfs_oracle(csr, f.root))
        st = sup.stats()
        assert st["quarantined"] == [bad] and st["timeouts"] == 1
        assert st["integrity"]["violations"] == 2
        assert st["retries"] == 6 and st["bisections"] == 5
        return ([outcome_of(f) for f in futures], sup_stats(sup),
                [ws_summary(w) for w in b.waves], chaos.plan.injected,
                chaos.flips)
    out = both(served, scenario)
    assert out[1]["demotions"] == ["packed->boolplane"]
