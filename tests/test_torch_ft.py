"""The port's fault-tolerance layer (``repro_torch.ft``) against the
reference's (``repro.ft``).

Every differential case runs one scenario under both packages — the same
scripted fake engines, fault plans and injected sleeps — and compares what
comes out: each root's row or error type (and the type of its chained
cause), the quarantined roots, the per-wave and lifetime counters, and the
demotion labels (the reference's ``pallas->jnp`` is the port's
``kernels->torch``).  The scenario's own assertions, those of the
reference's ``tests/test_ft.py`` and of the host checks of
``tests/test_integrity.py``, run under both packages.

The card's ladder has no counterpart in the reference: it is tested here on
a double whose graph names a CUDA device (nothing runs on a card), and on a
real runner in ``tests/test_torch_cuda.py``.
"""
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import torch                                               # noqa: E402

import repro.ft as jft                                     # noqa: E402
import repro.ft.integrity as jint                          # noqa: E402
from repro.core import BudgetOverflowError as JBudget      # noqa: E402
from repro.core.bfs_local import INF as JINF               # noqa: E402
import repro_torch.ft as tft                               # noqa: E402
import repro_torch.ft.integrity as tint                    # noqa: E402
from repro_torch.core import BudgetOverflowError as TBudget  # noqa: E402
from repro_torch.core.bfs_local import INF                 # noqa: E402
from repro_torch.kernels import _build                     # noqa: E402

REF = SimpleNamespace(name="ref", ft=jft, integrity=jint, Budget=JBudget,
                      knob="use_pallas", breaker="break_pallas", INF=JINF)
PORT = SimpleNamespace(name="port", ft=tft, integrity=tint, Budget=TBudget,
                       knob="use_kernels", breaker="break_kernels", INF=INF)
LABELS = {"pallas->jnp": "kernels->torch"}

N = 16          # |V| of the fake engines' imaginary graph


def both(scenario):
    """Run ``scenario(P)`` for the reference and the port; their summaries
    must be equal.  Returns the port's."""
    ref, port = scenario(REF), scenario(PORT)
    assert ref == port
    return port


def labels(demotions):
    return [LABELS.get(d, d) for d in demotions]


def outcome(o):
    err = o.error
    return (o.root,
            None if o.levels is None else np.asarray(o.levels).tolist(),
            None if err is None else type(err).__name__,
            None if err is None or err.__cause__ is None
            else type(err.__cause__).__name__)


def wave_summary(w):
    return dict(outcomes=[outcome(o) for o in w.outcomes],
                traversals=w.traversals, fault_waves=w.fault_waves,
                retries=w.retries, timeouts=w.timeouts,
                bisections=w.bisections,
                budget_escalations=w.budget_escalations,
                quarantined=list(w.quarantined),
                demotions=labels(w.demotions))


def stats_summary(sup):
    """Lifetime counters, less what depends on wall time (the derived
    deadline and the straggler count read measured durations)."""
    s = dict(sup.stats())
    s["demotions"] = labels(s["demotions"])
    s.pop("stragglers", None)
    if sup.wave_deadline is None:
        s.pop("wave_deadline", None)
    return s


class ScriptedEngine:
    """Serves ``levels[i][:] = root`` after raising scripted failures.

    ``script`` is a list consumed one entry per ``run_batch`` call:
    an exception instance to raise, or None to serve.  An exhausted
    script serves.  Records every call's (roots, budget).
    """

    def __init__(self, script=(), stats=None):
        self.script = list(script)
        self.calls = []
        self.last_stats = dict(stats or {})

    def run_batch(self, roots, *, budget=None):
        roots = np.asarray(roots)
        self.calls.append((roots.tolist(), budget))
        if self.script:
            exc = self.script.pop(0)
            if exc is not None:
                raise exc
        return np.repeat(roots[:, None], N, axis=1)


def expected_rows(roots):
    return np.repeat(np.asarray(roots)[:, None], N, axis=1)


def make_supervisor(P, engine, **kw):
    kw.setdefault("backoff", 0.0)
    kw.setdefault("watchdog", False)
    kw.setdefault("pad_to_plane", False)
    return P.ft.EngineSupervisor(engine, **kw)


# ---------------------------------------------------------------------------
# taxonomy + helpers
# ---------------------------------------------------------------------------

def test_classify_fault():
    def scenario(P):
        det = [ValueError("x"), TypeError("x"), IndexError("x"),
               KeyError("x"), NotImplementedError("x"),
               P.ft.PoisonedRoot("x")]
        tra = [RuntimeError("x"), P.ft.InjectedFailure("x"),
               P.ft.KernelFault("x"), P.ft.WaveTimeout("x"), OSError("x"),
               MemoryError("x"), P.Budget(8, 99, 3)]
        for exc in det:
            assert P.ft.classify_fault(exc) == P.ft.DETERMINISTIC
        for exc in tra:
            assert P.ft.classify_fault(exc) == P.ft.TRANSIENT
        return [P.ft.classify_fault(e) for e in det + tra]
    both(scenario)


def test_is_kernel_fault():
    """Typed faults, integrity violations and deterministic classes agree
    across the packages; the string fingerprints are each package's own
    (the reference's Pallas/XLA, the port's CUDA/nvcc/Triton)."""
    def scenario(P):
        return [P.ft.is_kernel_fault(e) for e in (
            P.ft.KernelFault("boom"), RuntimeError("disk on fire"),
            ValueError("pallas cuda nvcc triton"),
            RuntimeError("triton compilation error"),
            P.integrity.IntegrityError("corrupt word"))]
    assert both(scenario) == [True, False, False, True, True]
    assert jft.is_kernel_fault(RuntimeError("pallas lowering failed"))
    assert jft.is_kernel_fault(RuntimeError("XLA compilation error"))
    assert tft.is_kernel_fault(RuntimeError("nvcc failed for x.cu (rc 1)"))
    assert tft.is_kernel_fault(RuntimeError("k: CUDA error 700 at launch"))
    assert not tft.is_kernel_fault(ValueError("CUDA error at launch"))


def test_is_kernel_fault_matches_the_launch_and_build_errors():
    """The port's own launch and build failures drive its ladder."""
    with pytest.raises(RuntimeError) as launch:
        _build.raise_on_error(700, "msbfs_propagate_planes")
    assert tft.is_kernel_fault(launch.value)
    assert not tft.is_kernel_fault(RuntimeError("disk on fire"))


def test_supports_budget_override():
    class NoBudget:
        def run_batch(self, roots):
            return roots

    class Kwargs:
        def run_batch(self, roots, **kw):
            return roots

    def scenario(P):
        got = [P.ft.supports_budget_override(e)
               for e in (ScriptedEngine(), NoBudget(), Kwargs())]
        assert got == [True, False, True]
        return got
    both(scenario)


def test_find_tunable_engine_walks_wrappers():
    class Wrap:
        def __init__(self, inner):
            self.inner = inner

    def scenario(P):
        t = SimpleNamespace(**{P.knob: True, "packed": True})
        assert P.ft.find_tunable_engine(t) is t
        assert P.ft.find_tunable_engine(Wrap(Wrap(t))) is t
        assert P.ft.find_tunable_engine(Wrap(object())) is None
        # the port's knob is use_kernels: the reference's name is not one
        other = SimpleNamespace(use_pallas=True, use_kernels=True)
        return P.ft.find_tunable_engine(other) is other
    both(scenario)
    assert tft.find_tunable_engine(SimpleNamespace(use_pallas=True)) is None


# ---------------------------------------------------------------------------
# failures.py primitives
# ---------------------------------------------------------------------------

def test_failure_injector_fires_exactly_once():
    def scenario(P):
        inj = P.ft.FailureInjector(fail_at=(3, 7))
        fired = []
        for step in (0, 3, 3, 7, 7):
            try:
                inj.check(step)
                fired.append(False)
            except P.ft.InjectedFailure:
                fired.append(True)
        assert fired == [False, True, False, True, False]
        return fired
    both(scenario)


def test_step_timer_median_and_stragglers():
    def scenario(P):
        t = P.ft.StepTimer(k=3.0, window=50)
        assert t.median() is None
        flags = [t.record(i, d) for i, d in enumerate([0.1] * 4)]
        assert flags == [False] * 4          # < 5 samples: never flagged
        assert t.median() == pytest.approx(0.1)
        assert t.record(4, 1.0)              # 1.0 > 3 x 0.1, 5 samples
        assert not t.record(5, 0.25)         # above median, under k x
        return t.flags, t.median()
    assert both(scenario)[0] == [4]


def test_run_with_retries_replays_from_checkpoint():
    """The retry loop against an in-memory checkpoint store: every failure
    restores the latest checkpoint and replays to an exact final state;
    both packages take the same restarts in the same order."""
    def scenario(P):
        store = {}
        state = {"x": np.zeros(4, np.int64)}
        executed = []

        def step_fn(step):
            state["x"] = state["x"] + step
            store[step] = state["x"].copy()
            executed.append(step)

        def restore_fn():
            if not store:
                state["x"] = np.zeros(4, np.int64)
                return 0
            s = max(store)
            state["x"] = store[s].copy()
            return s + 1

        timer = P.ft.StepTimer()
        inj = P.ft.FailureInjector(fail_at=(0, 3, 5))
        done, restarts = P.ft.run_with_retries(
            step_fn, restore_fn, num_steps=8, injector=inj, timer=timer)
        assert done == 8 and restarts == 3
        np.testing.assert_array_equal(state["x"],
                                      np.full(4, sum(range(8)), np.int64))
        assert len(timer.durations) == len(executed) == 8

        def perma_broken(step):
            raise RuntimeError("permanent")

        with pytest.raises(RuntimeError):
            P.ft.run_with_retries(perma_broken, lambda: 0, num_steps=1,
                                  max_retries=2)
        return done, restarts, executed, state["x"].tolist()
    both(scenario)


# ---------------------------------------------------------------------------
# supervisor: retry / abandon
# ---------------------------------------------------------------------------

def test_clean_wave_passes_through():
    def scenario(P):
        sup = make_supervisor(P, ScriptedEngine())
        wave = sup.run_wave([3, 5, 9])
        assert wave.n_ok == 3 and wave.n_failed == 0
        np.testing.assert_array_equal(wave.levels(),
                                      expected_rows([3, 5, 9]))
        np.testing.assert_array_equal(sup.run_batch([4]), expected_rows([4]))
        assert sup.stats()["waves"] == 2
        return wave_summary(wave), stats_summary(sup)
    both(scenario)


def test_transient_fault_retries_and_succeeds():
    def scenario(P):
        eng = ScriptedEngine(script=[P.ft.InjectedFailure("flaky"),
                                     P.ft.KernelFault("flaky")])
        slept = []
        sup = make_supervisor(P, eng, max_retries=2, backoff=0.01,
                              sleep=slept.append, jitter=False)
        wave = sup.run_wave([1, 2])
        assert wave.n_ok == 2 and wave.traversals == 3
        assert slept == [0.01, 0.02]         # exponential, injected sleep
        return wave_summary(wave), stats_summary(sup), slept, eng.calls
    both(scenario)


def test_transient_exhaustion_abandons_with_typed_error():
    def scenario(P):
        eng = ScriptedEngine(script=[RuntimeError("down")] * 10)
        sup = make_supervisor(P, eng, max_retries=2)
        wave = sup.run_wave([1, 2, 3])
        assert wave.n_failed == 3 and wave.traversals == 3
        for o in wave.outcomes:
            assert isinstance(o.error, P.ft.WaveAbandoned)
        with pytest.raises(P.ft.WaveAbandoned):
            wave.levels()
        eng2 = ScriptedEngine(script=[RuntimeError("down")] * 10)
        with pytest.raises(P.ft.WaveAbandoned):
            make_supervisor(P, eng2, max_retries=1).run_batch([1])
        return wave_summary(wave), stats_summary(sup), len(eng2.calls)
    both(scenario)


def test_zero_retries_means_single_attempt():
    def scenario(P):
        sup = make_supervisor(P, ScriptedEngine(
            script=[RuntimeError("down")]), max_retries=0)
        wave = sup.run_wave([1])
        assert wave.traversals == 1 and wave.n_failed == 1
        return wave_summary(wave)
    both(scenario)


# ---------------------------------------------------------------------------
# supervisor: quarantine bisection
# ---------------------------------------------------------------------------

def poison_engine(P, poison):
    class PoisonEngine(ScriptedEngine):
        def run_batch(self, roots, *, budget=None):
            if int(poison) in np.asarray(roots).tolist():
                self.calls.append((np.asarray(roots).tolist(), budget))
                raise P.ft.PoisonedRoot(f"root {poison}")
            return super().run_batch(roots, budget=budget)
    return PoisonEngine()


@pytest.mark.parametrize("batch", [2, 8, 32])
def test_bisection_isolates_poison_within_log_bound(batch):
    def scenario(P):
        roots = list(range(batch))
        poison = batch // 2
        eng = poison_engine(P, poison)
        sup = make_supervisor(P, eng)
        wave = sup.run_wave(roots)
        assert wave.quarantined == [poison]
        assert wave.n_failed == 1 and wave.n_ok == batch - 1
        err = wave.outcomes[poison].error
        assert isinstance(err, P.ft.RequestQuarantined)
        assert isinstance(err.__cause__, P.ft.PoisonedRoot)
        assert wave.fault_waves <= math.ceil(math.log2(batch)) + 1
        assert wave.bisections >= 1
        return wave_summary(wave), stats_summary(sup), eng.calls
    both(scenario)


def test_bisection_isolates_multiple_poisons():
    def scenario(P):
        class MultiPoison(ScriptedEngine):
            def run_batch(self, roots, *, budget=None):
                bad = sorted(set(np.asarray(roots).tolist()) & {2, 5})
                if bad:
                    raise P.ft.PoisonedRoot(f"roots {bad}")
                return super().run_batch(roots, budget=budget)

        sup = make_supervisor(P, MultiPoison())
        wave = sup.run_wave(list(range(8)))
        assert sorted(wave.quarantined) == [2, 5] and wave.n_ok == 6
        return wave_summary(wave)
    both(scenario)


def test_singleton_deterministic_failure_quarantines_without_bisection():
    def scenario(P):
        sup = make_supervisor(P, ScriptedEngine(
            script=[ValueError("bad root")]))
        wave = sup.run_wave([7])
        assert wave.quarantined == [7] and wave.bisections == 0
        assert isinstance(wave.outcomes[0].error, P.ft.RequestQuarantined)
        return wave_summary(wave)
    both(scenario)


# ---------------------------------------------------------------------------
# supervisor: budget escalation
# ---------------------------------------------------------------------------

def overflow_engine(P, need=64):
    class OverflowEngine(ScriptedEngine):
        """Overflows until called with budget >= need, then serves and
        reports the settled budget in last_stats (like the runner)."""

        def run_batch(self, roots, *, budget=None):
            got = int(budget or 8)
            if got < need:
                self.calls.append((np.asarray(roots).tolist(), budget))
                raise P.Budget(got, need, 2)
            self.last_stats = {"overflow_retries": 1, "budget": got}
            return super().run_batch(roots, budget=budget)
    return OverflowEngine()


def test_budget_overflow_escalates_via_per_wave_override():
    def scenario(P):
        eng = overflow_engine(P)
        sup = make_supervisor(P, eng, max_retries=5)
        wave = sup.run_wave([1, 2])
        assert wave.n_ok == 2
        assert [b for _, b in eng.calls] == [None, 16, 32, 64]
        assert wave.budget_escalations == 3
        assert sup.stats()["budget_hint"] == 64
        first = list(eng.calls)
        eng.calls.clear()
        sup.run_wave([3])
        assert [b for _, b in eng.calls] == [64]
        return wave_summary(wave), stats_summary(sup), first
    both(scenario)


def test_budget_escalation_disabled():
    def scenario(P):
        eng = overflow_engine(P)
        sup = make_supervisor(P, eng, max_retries=2, escalate_budget=False)
        wave = sup.run_wave([1])
        assert wave.n_failed == 1 and wave.budget_escalations == 0
        assert [b for _, b in eng.calls] == [None, None, None]
        return wave_summary(wave)
    both(scenario)


def test_budget_kwarg_not_forced_on_engines_without_support():
    class NoBudget:
        last_stats = {}

        def run_batch(self, roots):
            return np.repeat(np.asarray(roots)[:, None], N, axis=1)

    def scenario(P):
        sup = make_supervisor(P, NoBudget())
        sup._budget_hint = 999
        wave = sup.run_wave([1, 2])
        assert wave.n_ok == 2
        return wave_summary(wave)
    both(scenario)


# ---------------------------------------------------------------------------
# supervisor: degradation ladder (the CPU ladder of both packages)
# ---------------------------------------------------------------------------

def ladder_engine(P):
    """Kernel-faults while the kernel knob is on (a broken toolchain)."""
    class LadderEngine(ScriptedEngine):
        def __init__(self):
            super().__init__()
            setattr(self, P.knob, True)
            self.packed = True

        def run_batch(self, roots, *, budget=None):
            if getattr(self, P.knob):
                self.calls.append((np.asarray(roots).tolist(), budget))
                raise P.ft.KernelFault("kernel lowering failed")
            return super().run_batch(roots, budget=budget)
    return LadderEngine()


def test_ladder_demotes_kernels_to_torch_and_restores():
    def scenario(P):
        eng = ladder_engine(P)
        sup = make_supervisor(P, eng, max_retries=3)
        wave = sup.run_wave([1, 2])
        assert wave.n_ok == 2
        assert labels(wave.demotions) == ["kernels->torch"]
        assert wave.fault_waves == 2 and wave.traversals == 3
        assert getattr(eng, P.knob) is True and eng.packed is True
        return wave_summary(wave), stats_summary(sup)
    both(scenario)


def test_ladder_sticky_demotions_persist():
    def scenario(P):
        eng = ladder_engine(P)
        sup = make_supervisor(P, eng, max_retries=3, sticky_demotions=True)
        sup.run_wave([1])
        assert getattr(eng, P.knob) is False
        wave2 = sup.run_wave([2])
        assert wave2.traversals == 1 and wave2.demotions == []
        return wave_summary(wave2), stats_summary(sup)
    assert both(scenario)[1]["demotions"] == ["kernels->torch"]


def test_ladder_second_rung_unpacks():
    def scenario(P):
        class AlwaysKernelFault(ScriptedEngine):
            def __init__(self):
                super().__init__()
                setattr(self, P.knob, True)
                self.packed = True

            def run_batch(self, roots, *, budget=None):
                if getattr(self, P.knob) or self.packed:
                    raise P.ft.KernelFault("kernel fault")
                return super().run_batch(roots, budget=budget)

        sup = make_supervisor(P, AlwaysKernelFault(), max_retries=5)
        wave = sup.run_wave([4])
        assert wave.n_ok == 1
        return wave_summary(wave)
    assert both(scenario)["demotions"] == ["kernels->torch",
                                           "packed->boolplane"]


def test_ladder_disabled_never_touches_knobs():
    def scenario(P):
        eng = ladder_engine(P)
        sup = make_supervisor(P, eng, max_retries=2, degrade=False)
        wave = sup.run_wave([1])
        assert wave.n_failed == 1 and wave.demotions == []
        assert getattr(eng, P.knob) is True
        return wave_summary(wave)
    both(scenario)


def test_demotion_grants_watchdog_slack():
    def scenario(P):
        eng = ladder_engine(P)
        sup = make_supervisor(P, eng, max_retries=3, watchdog=True,
                              wave_deadline=1.0, demotion_slack=4.0,
                              sticky_demotions=True)
        before = sup.current_deadline()
        sup.run_wave([1])
        after = sup.current_deadline()
        sup2 = make_supervisor(P, ladder_engine(P), max_retries=3,
                               watchdog=True, wave_deadline=1.0)
        sup2.run_wave([1])
        return before, after, sup2.current_deadline()
    assert both(scenario) == (pytest.approx(1.0), pytest.approx(4.0),
                              pytest.approx(1.0))


# ---------------------------------------------------------------------------
# supervisor: the card's ladder (port only)
# ---------------------------------------------------------------------------

class CardEngine(ScriptedEngine):
    """A tunable double whose graph names a CUDA device.  It kernel-faults
    while packed, and refuses to have its kernels turned off, as a runner
    on the card would (``resolve_use_kernels`` raises there)."""

    def __init__(self, packed=True, fail_packed=True):
        super().__init__()
        self.g = SimpleNamespace(device=torch.device("cuda", 0))
        self.use_kernels = True
        self.packed = packed
        self.fail_packed = fail_packed
        self.packed_calls = []

    def __setattr__(self, name, value):
        if name == "use_kernels" and not value:
            raise AssertionError("use_kernels turned off on the card")
        super().__setattr__(name, value)

    def run_batch(self, roots, *, budget=None):
        self.packed_calls.append(self.packed)
        if self.packed and self.fail_packed:
            raise tft.KernelFault("msbfs_propagate_planes: CUDA error 700 "
                                  "at launch")
        # rows the integrity checks accept: each root alone at level 0
        roots = np.asarray(roots)
        rows = np.full((roots.size, N), INF, np.int32)
        rows[np.arange(roots.size), roots] = 0
        return rows


def test_card_ladder_passes_over_the_torch_rung():
    eng = CardEngine()
    sup = make_supervisor(PORT, eng, max_retries=3, watchdog=True,
                          wave_deadline=1.0, demotion_slack=4.0,
                          sticky_demotions=True)
    wave = sup.run_wave([1, 2])
    assert wave.n_ok == 2
    assert wave.demotions == ["kernels->boolplane"]
    assert eng.use_kernels is True and eng.packed is False
    assert eng.packed_calls == [True, True, False]
    # one demotion passing over the torch rung scales once for each rung
    assert sup.current_deadline() == pytest.approx(16.0)
    # the bottom of the card's ladder: nothing further to demote
    assert sup._demote() is None and eng.use_kernels is True


def test_card_ladder_restores_packed_after_the_wave():
    eng = CardEngine()
    sup = make_supervisor(PORT, eng, max_retries=3, watchdog=True,
                          wave_deadline=0.5)
    wave = sup.run_wave([3])
    assert wave.n_ok == 1 and wave.demotions == ["kernels->boolplane"]
    assert eng.packed is True and eng.use_kernels is True
    assert sup.current_deadline() == pytest.approx(0.5)
    assert sup.stats()["demotions"] == ["kernels->boolplane"]


def test_card_break_kernels_abandons_rather_than_turning_kernels_off():
    eng = CardEngine(fail_packed=False)
    chaos = tft.FaultyEngine(eng, break_kernels=True)
    sup = make_supervisor(PORT, chaos, max_retries=3)
    wave = sup.run_wave([1])
    assert wave.demotions == ["kernels->boolplane"]
    assert isinstance(wave.outcomes[0].error, tft.WaveAbandoned)
    assert eng.use_kernels is True


def test_card_audit_reruns_packed_waves_on_the_boolplane_rung():
    eng = CardEngine(fail_packed=False)
    sup = make_supervisor(PORT, eng, integrity=tft.IntegrityConfig(
        mode="audit", audit_rate=1.0))
    wave = sup.run_wave([1, 2])
    assert wave.n_ok == 2
    assert eng.packed_calls == [True, False]       # served, then audited
    assert eng.packed is True and eng.use_kernels is True
    st = sup.stats()["integrity"]
    assert st["audits"] == 1 and st["audit_failures"] == 0


def test_card_audit_on_a_boolplane_engine_returns():
    """A bool-plane engine on the card has no rung left that the card may
    run: the audit returns without touching ``use_kernels``."""
    eng = CardEngine(packed=False, fail_packed=False)
    sup = make_supervisor(PORT, eng, integrity=tft.IntegrityConfig(
        mode="audit", audit_rate=1.0))
    for _ in range(3):
        assert sup.run_wave([4, 5]).n_ok == 2
    assert eng.packed_calls == [False] * 3
    assert sup.stats()["integrity"]["audits"] == 0
    assert eng.use_kernels is True


# ---------------------------------------------------------------------------
# supervisor: watchdog
# ---------------------------------------------------------------------------

class StallEngine(ScriptedEngine):
    """Stalls (real wall clock) once, then serves instantly."""

    def __init__(self, stall=0.4):
        super().__init__()
        self.stall = stall
        self.stalled = False

    def run_batch(self, roots, *, budget=None):
        if not self.stalled:
            self.stalled = True
            time.sleep(self.stall)
        return super().run_batch(roots, budget=budget)


def test_watchdog_abandons_stuck_wave_and_retry_succeeds():
    def scenario(P):
        sup = P.ft.EngineSupervisor(StallEngine(stall=0.5), max_retries=2,
                                    backoff=0.0, wave_deadline=0.1,
                                    pad_to_plane=False)
        t0 = time.perf_counter()
        wave = sup.run_wave([1, 2])
        assert time.perf_counter() - t0 < 2.0
        assert wave.n_ok == 2 and wave.timeouts == 1 and wave.retries == 1
        return wave_summary(wave), stats_summary(sup)
    both(scenario)


def test_watchdog_timeout_is_typed_and_exhaustible():
    class AlwaysStuck(ScriptedEngine):
        def run_batch(self, roots, *, budget=None):
            time.sleep(0.3)
            return super().run_batch(roots, budget=budget)

    def scenario(P):
        sup = P.ft.EngineSupervisor(AlwaysStuck(), max_retries=1,
                                    backoff=0.0, wave_deadline=0.05,
                                    pad_to_plane=False)
        wave = sup.run_wave([5])
        assert wave.n_failed == 1 and wave.timeouts == 2
        assert isinstance(wave.outcomes[0].error, P.ft.WaveAbandoned)
        assert isinstance(wave.outcomes[0].error.__cause__,
                          P.ft.WaveTimeout)
        return wave_summary(wave)
    both(scenario)


def test_cold_engine_is_never_deadlined():
    def scenario(P):
        sup = P.ft.EngineSupervisor(ScriptedEngine(), watchdog=True)
        cold = sup.current_deadline()
        for _ in range(3):
            sup.run_wave([1])
        dl = sup.current_deadline()
        assert dl is not None and dl >= sup.min_deadline
        return cold
    assert both(scenario) is None


def test_explicit_deadline_beats_derived():
    def scenario(P):
        return (P.ft.EngineSupervisor(ScriptedEngine(),
                                      wave_deadline=7.5).current_deadline(),
                P.ft.EngineSupervisor(ScriptedEngine(),
                                      watchdog=False).current_deadline())
    assert both(scenario) == (pytest.approx(7.5), None)


# ---------------------------------------------------------------------------
# chaos harness doubles
# ---------------------------------------------------------------------------

def test_fault_plan_exact_once_and_validation():
    def scenario(P):
        plan = P.ft.FaultPlan([(0, "kernel"), (2, "stuck")])
        assert len(plan) == 2
        pops = [plan.pop(1), plan.pop(0), plan.pop(0), plan.pop(2)]
        assert len(plan) == 0
        with pytest.raises(ValueError, match="unknown fault kind"):
            P.ft.FaultPlan([(0, "gremlins")])
        with pytest.raises(ValueError, match="duplicate"):
            P.ft.FaultPlan([(0, "kernel"), (0, "runtime")])
        return pops, plan.injected, list(P.ft.FAULT_KINDS)
    pops, injected, _ = both(scenario)
    assert pops == [None, "kernel", None, "stuck"]
    assert injected == [(0, "kernel"), (2, "stuck")]


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_fault_plan_random_is_deterministic(seed):
    """The same seed gives the same schedule in both packages."""
    def scenario(P):
        a = P.ft.FaultPlan.random(100, 0.2, seed=seed)
        assert a.pending() == P.ft.FaultPlan.random(100, 0.2,
                                                    seed=seed).pending()
        assert 0 < len(a) < 100
        assert len(P.ft.FaultPlan.random(100, 0.0, seed=seed)) == 0
        mixed = P.ft.FaultPlan.random(
            64, 0.3, kinds=("kernel", "runtime", "stuck"), seed=seed)
        return a.pending(), mixed.pending()
    both(scenario)
    assert (tft.FaultPlan.random(100, 0.2, seed=7).pending()
            != tft.FaultPlan.random(100, 0.2, seed=8).pending())


def test_faulty_engine_injects_per_plan():
    def scenario(P):
        inner = ScriptedEngine()
        naps = []
        eng = P.ft.FaultyEngine(
            inner, P.ft.FaultPlan([(0, "kernel"), (1, "runtime"),
                                   (2, "stuck")]),
            stall_seconds=9.0, sleep=naps.append)
        with pytest.raises(P.ft.KernelFault):
            eng.run_batch([1])
        with pytest.raises(P.ft.InjectedFailure):
            eng.run_batch([1])
        rows = eng.run_batch([1])
        assert naps == [9.0]
        np.testing.assert_array_equal(rows, expected_rows([1]))
        assert eng.calls == 3 and len(inner.calls) == 1
        return naps, eng.plan.injected
    both(scenario)


def test_faulty_engine_poison_and_break_kernels():
    def scenario(P):
        inner = ladder_engine(P)
        setattr(inner, P.knob, False)            # healthy rung
        eng = P.ft.FaultyEngine(inner, poisoned_roots=[3])
        with pytest.raises(P.ft.PoisonedRoot):
            eng.run_batch([1, 3])
        np.testing.assert_array_equal(eng.run_batch([1, 2]),
                                      expected_rows([1, 2]))
        setattr(inner, P.knob, True)
        broken = P.ft.FaultyEngine(inner, **{P.breaker: True})
        with pytest.raises(P.ft.KernelFault):
            broken.run_batch([1])
        setattr(inner, P.knob, False)
        np.testing.assert_array_equal(broken.run_batch([1]),
                                      expected_rows([1]))
        return eng.calls, broken.calls
    both(scenario)


def test_faulty_engine_result_flip_is_exact_once_and_recorded():
    def scenario(P):
        eng = P.ft.FaultyEngine(ScriptedEngine(),
                                P.ft.FaultPlan([(1, "result_flip")]))
        clean = eng.run_batch([1, 2, 3])
        flipped = eng.run_batch([1, 2, 3])
        again = eng.run_batch([1, 2, 3])
        np.testing.assert_array_equal(clean, again)
        assert int((flipped != clean).sum()) == 1
        return flipped.tolist(), eng.flips
    both(scenario)


def test_supervisor_over_faulty_engine_end_to_end():
    def scenario(P):
        eng = P.ft.FaultyEngine(ScriptedEngine(),
                                P.ft.FaultPlan([(1, "kernel")]),
                                poisoned_roots=[6])
        sup = make_supervisor(P, eng, max_retries=2)
        wave = sup.run_wave(list(range(8)))
        assert wave.quarantined == [6]
        assert wave.n_ok == 7 and wave.n_failed == 1
        assert eng.plan.injected == [(1, "kernel")]
        assert wave.retries >= 1 and wave.fault_waves >= 2
        return wave_summary(wave), stats_summary(sup), eng.calls
    both(scenario)


def test_per_wave_slo_deadline_overrides_watchdog():
    def scenario(P):
        sup = P.ft.EngineSupervisor(ScriptedEngine(), wave_deadline=7.5)
        got = []
        for o in (0.5, 0.01, 100.0, None):
            sup._wave_deadline_override = o
            got.append(sup.current_deadline())
        assert got == [pytest.approx(max(0.5, sup.min_deadline)),
                       pytest.approx(sup.min_deadline),
                       pytest.approx(7.5), pytest.approx(7.5)]
        return got
    both(scenario)


def test_run_wave_deadline_guards_cold_engine():
    def scenario(P):
        sup = P.ft.EngineSupervisor(StallEngine(stall=0.5), max_retries=2,
                                    backoff=0.0, pad_to_plane=False)
        assert sup.current_deadline() is None
        wave = sup.run_wave([1, 2], deadline=0.1)
        assert wave.n_ok == 2 and wave.timeouts == 1 and wave.retries == 1
        assert sup._wave_deadline_override is None
        assert sup.current_deadline() is None
        return wave_summary(wave)
    both(scenario)


def test_jitter_backoff_within_envelope_and_decorrelated():
    """Seeded jitter gives the same delays in both packages; unseeded
    supervisors diverge."""
    def run_once(P, seed=None):
        eng = ScriptedEngine(script=[P.ft.InjectedFailure("correlated")] * 4)
        sup = make_supervisor(P, eng, max_retries=4, backoff=0.01,
                              backoff_cap=0.5, sleep=lambda s: None,
                              jitter_seed=seed)
        assert sup.run_wave([1, 2]).n_ok == 2
        return list(sup.backoff_log)

    def scenario(P):
        log = run_once(P, seed=7)
        assert len(log) == 4 and log[0] == 0.01
        for prev, d in zip(log, log[1:]):
            assert 0.01 <= d <= min(0.5, 3.0 * max(prev, 0.01 / 3))
        assert run_once(P, seed=7) != run_once(P, seed=8)
        assert run_once(P) != run_once(P)
        return log
    both(scenario)


# ---------------------------------------------------------------------------
# integrity: the host checks and the config
# ---------------------------------------------------------------------------

def test_check_level_rows_accepts_clean_and_rejects_corruption():
    def scenario(P):
        inf = int(P.INF)
        rows = np.asarray([[0, 1, 2, inf], [1, 0, inf, 2]], np.int32)
        roots = np.asarray([0, 1])
        P.integrity.check_level_rows(rows, roots, iterations=2)
        msgs = []
        bad = rows.copy()
        bad[1, 3] = 7
        lost = rows.copy()
        lost[0, 0] = 3
        for r, it, match in ((bad, 2, "outside"), (lost, 3, "lost its root"),
                             (rows - 1, None, None)):
            with pytest.raises(P.integrity.IntegrityError,
                               match=match) as exc:
                P.integrity.check_level_rows(r, roots, iterations=it)
            msgs.append(str(exc.value))
        return msgs
    both(scenario)


@pytest.mark.parametrize("pcs,msg", [
    ([], "empty"),
    ([3, -1, 0], "negative"),
    ([0, 2, 0], "roots must seed"),
    ([4, 0, 3, 0], "hit 0 at level 1"),
    ([4, 2], "not drained"),
])
def test_check_popcount_sequence_rejects(pcs, msg):
    def scenario(P):
        with pytest.raises(P.integrity.IntegrityError, match=msg) as exc:
            P.integrity.check_popcount_sequence(pcs)
        return str(exc.value)
    both(scenario)


def test_check_popcount_sequence_accepts():
    for P in (REF, PORT):
        P.integrity.check_popcount_sequence([32])
        P.integrity.check_popcount_sequence([32, 100, 7, 0])


def test_integrity_config_validation():
    import dataclasses

    def scenario(P):
        modes = P.integrity.INTEGRITY_MODES
        assert P.integrity.IntegrityConfig().mode in modes
        with pytest.raises(ValueError):
            P.integrity.IntegrityConfig(mode="paranoid")
        with pytest.raises(ValueError):
            P.integrity.IntegrityConfig(audit_rate=1.5)
        cfg = P.integrity.IntegrityConfig(mode="audit", audit_rate=0.5)
        with pytest.raises(dataclasses.FrozenInstanceError):
            cfg.mode = "off"
        return dataclasses.asdict(P.integrity.IntegrityConfig()), list(
            P.integrity.INTEGRITY_MODES)
    both(scenario)


def test_integrity_error_is_kernel_class_transient():
    def scenario(P):
        err = P.integrity.IntegrityError("corrupt frontier word")
        return P.ft.classify_fault(err), P.ft.is_kernel_fault(err)
    assert both(scenario) == (tft.TRANSIENT, True)


def test_ft_exports_match_the_reference():
    assert sorted(tft.__all__) == sorted(jft.__all__)
