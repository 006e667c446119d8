"""Fault tolerance primitives: failure injection, retry-from-checkpoint,
straggler timing (PyTorch port of ``repro.ft.failures``; pure Python).

At 1000+ nodes, the dominant failure modes are (a) preempted/crashed hosts,
(b) slow hosts (stragglers), (c) data corruption.  These primitives are the
single-controller analogues, and they are LIVE policy, not documentation:
``repro_torch.ft.supervisor.EngineSupervisor`` wires them around the serving
engine (``launch.dynbatch`` delegates its whole failure policy to it), and
the chaos harness (``FaultPlan`` / ``FaultyEngine`` in the same module)
drives them deterministically in tests and CI.

* ``run_with_retries`` — wraps a step function; on failure restores the
  latest checkpoint and replays (the data pipeline is a pure function of
  (seed, step), so replay is exact).
* ``FailureInjector`` — deterministic exact-once fault schedule keyed by
  step number (the training-loop counterpart of ``FaultPlan``'s
  wave-indexed schedule).
* ``StepTimer`` — records step durations and flags stragglers above k× the
  running median.  The serving supervisor feeds every engine-wave duration
  through one of these, and derives its wave-watchdog deadline from the
  same running median (``StepTimer.median``), so the deadline tracks the
  measured service time instead of a hand-tuned constant.
"""
from __future__ import annotations

import time


class InjectedFailure(RuntimeError):
    """A fault raised by the deterministic injection machinery (transient
    by definition: the schedule is exact-once, so a retry succeeds)."""


class FailureInjector:
    """Raises InjectedFailure at the scheduled step numbers (once each)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise InjectedFailure(f"injected failure at step {step}")


class StepTimer:
    """Tracks step durations; flags stragglers above k× the running median.

    Besides flagging, the running median is the calibration input for the
    serving wave watchdog: ``EngineSupervisor`` deadlines a wave at
    ``k * median`` of the recent history (clamped), so one stuck wave is
    abandoned instead of stalling the whole batcher.
    """

    def __init__(self, k: float = 3.0, window: int = 50):
        self.k = k
        self.window = window
        self.durations: list[float] = []
        self.flags: list[int] = []

    def median(self) -> float | None:
        """Running median over the retained window (None before any
        record) — the watchdog-deadline calibration input."""
        if not self.durations:
            return None
        hist = sorted(self.durations[-self.window:])
        return hist[len(hist) // 2]

    def record(self, step: int, seconds: float) -> bool:
        self.durations.append(seconds)
        med = self.median()
        if len(self.durations[-self.window:]) >= 5 and seconds > self.k * med:
            self.flags.append(step)
            return True
        return False


def run_with_retries(step_fn, restore_fn, num_steps: int, start_step: int = 0,
                     max_retries: int = 3, injector: FailureInjector | None = None,
                     timer: StepTimer | None = None):
    """Drive ``step_fn(step) -> state`` with restore-and-replay on failure.

    restore_fn() -> step to resume from (reloads state inside).
    Returns (completed_steps, num_restarts).
    """
    step = start_step
    restarts = 0
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.check(step)
            step_fn(step)
            if timer is not None:
                timer.record(step, time.perf_counter() - t0)
            step += 1
        except (InjectedFailure, RuntimeError):
            restarts += 1
            if restarts > max_retries:
                raise
            step = restore_fn()
    return step, restarts
