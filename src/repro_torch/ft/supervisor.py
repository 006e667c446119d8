"""Fault-tolerant serving: the engine supervisor (PyTorch port of
``repro.ft.supervisor``; host Python over the ``BFSEngine`` protocol).

ScalaBFS earns its GTEPS by keeping all 32 HBM pseudo-channels busy every
cycle; the serving-stack analogue of one stalled channel is a hung or
poisoned wave taking the whole ``DynamicBatcher`` down with it.  This
module wraps any ``BFSEngine`` (the protocol in
``repro_torch.core.bfs_local``)
in an :class:`EngineSupervisor` that makes per-wave behavior bounded and
typed — the property the memory-access-pattern literature (Dann & Ritter
2021, GraphScale 2022) identifies as what graph accelerators live or die
by under skewed inputs:

* **Wave watchdog** — each engine call gets a deadline derived from the
  recent :class:`~repro_torch.ft.failures.StepTimer` history (``k × running
  median``, clamped) or set explicitly; a wave that exceeds it is
  abandoned and surfaces as a typed :class:`WaveTimeout` instead of
  stalling the batcher forever.
* **Typed retry with backoff** — transient faults (injected, kernel,
  runtime) retry the whole wave up to ``max_retries`` with exponential
  backoff; exhausted retries fail the wave's requests with
  :class:`WaveAbandoned`.
* **Quarantine bisection** — a wave that fails *deterministically* (bad
  input classes: ``ValueError``/``TypeError``/…) is split in half and each
  half retried recursively, isolating the poisoned request(s) in O(log B)
  extra traversals so the other B−1 co-batched users still get answers.
  The isolated root's future fails with :class:`RequestQuarantined`
  chaining the root cause.
* **Graceful degradation ladder** — repeated kernel faults step the engine
  down its rungs (per-wave by default, ``sticky_demotions=True`` to keep),
  recording each demotion.  On a CPU runner the ladder is the reference's:
  ``use_kernels=True → plain torch → packed=False`` (labels
  ``kernels->torch``, ``packed->boolplane``).  On a CUDA runner the plain
  torch rung does not exist (``use_kernels=False`` is a CPU path only), so
  one demotion, ``kernels->boolplane``, passes over it to the bool-plane
  engine, whose P3 is kernel K3; the supervisor never turns the kernels
  off on the card.  Persistent push-budget overflow
  (``core.vertex_program.BudgetOverflowError``) escalates the edge budget
  for the retry wave via the engine's per-wave ``budget=`` override.
* **Deterministic chaos harness** — :class:`FaultPlan` schedules
  (wave-index, fault-kind) injections exactly once at the engine boundary
  and :class:`FaultyEngine` is the matching test double, so chaos tests
  are fully reproducible.

The supervisor itself satisfies the ``BFSEngine`` protocol
(``num_vertices`` / ``out_deg`` / ``run_batch`` / ``last_stats``) so it
drops in front of ``DynamicBatcher`` transparently; the batcher detects it
and delegates per-request resolution to :meth:`EngineSupervisor.run_wave`.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time

import numpy as np

from repro_torch.core import bitmap
from repro_torch.core.bfs_local import engine_num_vertices
from repro_torch.core.vertex_program import (BudgetOverflowError,
                                             IntegrityError)
from repro_torch.ft.failures import InjectedFailure, StepTimer
from repro_torch.ft.integrity import (IntegrityConfig, check_level_rows,
                                      check_popcount_sequence)

# ---------------------------------------------------------------------------
# Typed error taxonomy
# ---------------------------------------------------------------------------


class ServingError(RuntimeError):
    """Base of the serving fault taxonomy (every supervisor-raised error)."""


class KernelFault(ServingError):
    """A device-kernel (CUDA/Triton) failure — transient at wave scope, but
    repeated occurrences drive the degradation ladder."""


class WaveTimeout(ServingError):
    """The wave exceeded its watchdog deadline and was abandoned."""


class WaveAbandoned(ServingError):
    """Transient faults persisted past ``max_retries``; the wave's
    requests fail with this error chaining the last fault."""


class RequestQuarantined(ServingError):
    """Bisection isolated this root as the deterministic poison in its
    wave; the root cause is chained as ``__cause__``."""


class PoisonedRoot(ValueError):
    """A request that deterministically fails its wave (test double's
    poison marker; ``ValueError`` so it classifies as deterministic just
    like a malformed-input rejection)."""


TRANSIENT, DETERMINISTIC = "transient", "deterministic"

# Input-shaped errors: retrying the identical wave cannot help, so the
# supervisor bisects to isolate the poisoned request instead.
_DETERMINISTIC_TYPES = (ValueError, TypeError, IndexError, KeyError,
                        NotImplementedError)


def classify_fault(exc: BaseException) -> str:
    """Map an engine failure to the retry policy it gets.

    Deterministic (bad input — bisect, don't retry): ``ValueError`` and
    friends, the classes a malformed root / shape mismatch raises.
    Transient (retry with backoff): everything else — injected faults,
    kernel faults, runtime/device errors, watchdog timeouts.
    """
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return DETERMINISTIC
    return TRANSIENT


def is_kernel_fault(exc: BaseException) -> bool:
    """Kernel-shaped failures drive the degradation ladder.

    Typed :class:`KernelFault` always qualifies; otherwise best-effort
    string matching on the exception's type/module/message for the port's
    kernel fingerprints: a launch error
    (``kernels._build.raise_on_error``: "...: CUDA error N at launch"), a
    failed build ("nvcc failed for ..."), and Triton's.
    """
    if isinstance(exc, KernelFault):
        return True
    if isinstance(exc, IntegrityError):
        # a violated traversal invariant means the engine computed WRONG
        # words — a corrupted kernel rung is the prime suspect, so the
        # retry should walk the same degradation ladder
        return True
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return False
    blob = (f"{type(exc).__module__}.{type(exc).__name__} "
            f"{exc}").lower()
    return any(tag in blob for tag in ("cuda", "nvcc", "triton"))


def supports_budget_override(engine) -> bool:
    """True if ``engine.run_batch`` accepts the per-wave ``budget=`` kw
    (``VertexProgramRunner`` does; ``DistributedBFS`` does not)."""
    try:
        params = inspect.signature(engine.run_batch).parameters
    except (TypeError, ValueError):
        return False
    if "budget" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def find_tunable_engine(engine):
    """Walk a wrapper chain (``.inner`` / ``._inner`` / ``.engine``) to the
    object that owns the ``use_kernels`` / ``packed`` knobs the degradation
    ladder turns.  Returns None when nothing in the chain is tunable."""
    seen: set[int] = set()
    obj = engine
    while obj is not None and id(obj) not in seen:
        seen.add(id(obj))
        d = getattr(obj, "__dict__", {})
        if "use_kernels" in d or "packed" in d:
            return obj
        obj = (getattr(obj, "inner", None) or getattr(obj, "_inner", None)
               or getattr(obj, "engine", None))
    return None


def on_card(engine) -> bool:
    """True when ``engine``'s graph lives on a CUDA device.  There the
    plain torch rung does not exist (``use_kernels=False`` raises for a
    graph on CUDA), so the ladder and the audit never turn the kernels
    off on it."""
    g = getattr(engine, "g", None)
    return getattr(getattr(g, "device", None), "type", None) == "cuda"


# ---------------------------------------------------------------------------
# Per-wave outcome records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RootOutcome:
    """How one submitted root ended: a level row or a typed error."""

    root: int
    levels: np.ndarray | None = None
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.levels is not None


@dataclasses.dataclass
class SupervisedWave:
    """One logical wave's fate under the supervisor's policy."""

    roots: np.ndarray
    outcomes: list[RootOutcome]
    traversals: int = 0        # engine calls issued (retries + bisection)
    fault_waves: int = 0       # engine calls that raised
    retries: int = 0           # transient-fault retries
    timeouts: int = 0          # watchdog abandonments
    bisections: int = 0        # splits performed isolating poison
    budget_escalations: int = 0
    quarantined: list[int] = dataclasses.field(default_factory=list)
    demotions: list[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0       # engine-busy wall time incl. failed attempts
    stats: dict = dataclasses.field(default_factory=dict)
    _kernel_faults: int = dataclasses.field(default=0, repr=False)

    @property
    def n_ok(self) -> int:
        return sum(o.ok for o in self.outcomes)

    @property
    def n_failed(self) -> int:
        return len(self.outcomes) - self.n_ok

    def levels(self) -> np.ndarray:
        """Stacked [B, n] rows; raises the first typed error if any root
        failed (the strict engine-protocol view of a partial wave)."""
        for o in self.outcomes:
            if o.error is not None:
                raise o.error
        return np.stack([o.levels for o in self.outcomes])


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------


class EngineSupervisor:
    """Wrap a ``BFSEngine`` with watchdog + retry + bisection + degradation.

    One wave at a time (the dynamic batcher's worker already serializes
    waves); not safe for concurrent ``run_wave`` calls on one instance.

    Parameters
    ----------
    max_retries: transient-fault retries per (sub-)wave before abandoning.
    backoff / backoff_factor: exponential retry backoff seconds.
    wave_deadline: explicit watchdog deadline (seconds); None derives
        ``timer.k × running-median`` clamped to [min_deadline,
        max_deadline] once ≥ 3 wave durations are recorded (a cold engine
        is never deadlined — the first waves pay the kernels' nvcc
        builds).
    watchdog: False disables deadlines entirely (engine runs inline, no
        guard thread).
    degrade: enable the kernel-fault demotion ladder
        (``use_kernels → plain torch → packed=False`` on the CPU,
        ``packed=False`` with the kernels kept on the card).
    sticky_demotions: keep demotions across waves instead of restoring the
        engine's knobs at wave end.
    demotion_slack: multiply the watchdog deadline by this per rung
        stepped down — the ladder's lower rungs (plain torch, bool-plane)
        are known to be slower, and without slack a demoted wave would
        trip the same watchdog that the demotion was meant to satisfy.
        The card's ``kernels->boolplane`` passes over the torch rung and
        scales by ``demotion_slack`` squared, the bool-plane rung's
        deadline on the CPU ladder.
    escalate_budget: retry ``BudgetOverflowError`` waves with a doubled
        edge budget, and start later waves at the deepest budget a
        previous wave settled on (both via ``run_batch(budget=)``).
    pad_to_plane: pad every engine call to whole uint32 plane words so
        bisection sub-waves reuse the warmed wave shapes.
    integrity: an :class:`~repro_torch.ft.integrity.IntegrityConfig` (or a
        mode string) enabling per-wave answer validation: engine-side statvec
        invariants + witness reduction (pushed onto the tunable runner's
        knobs), host-side row/popcount checks on every served wave, and —
        mode ``audit`` — a rate-sampled full differential re-run against
        the reference path.  Violations raise
        :class:`~repro_torch.core.IntegrityError` inside the attempt,
        riding the normal retry/demotion policy.  None = off.
    jitter: decorrelate retry backoff (``delay = uniform(backoff,
        3 x delay)``, capped) so pool workers sharing a fault do not
        retry in lockstep; ``jitter_seed=None`` (default) seeds from OS
        entropy, so two supervisors' schedules diverge.
    timer / clock / sleep: injectable for deterministic tests.
    """

    def __init__(self, engine, *, max_retries: int = 2,
                 backoff: float = 0.02, backoff_factor: float = 2.0,
                 backoff_cap: float = 2.0,
                 wave_deadline: float | None = None,
                 min_deadline: float = 0.25, max_deadline: float = 60.0,
                 watchdog: bool = True, degrade: bool = True,
                 sticky_demotions: bool = False,
                 demotion_slack: float = 4.0,
                 escalate_budget: bool = True, pad_to_plane: bool = True,
                 integrity: IntegrityConfig | str | None = None,
                 jitter: bool = True, jitter_seed: int | None = None,
                 timer: StepTimer | None = None, clock=None, sleep=None):
        if max_retries < 0 or backoff < 0 or backoff_factor < 1:
            raise ValueError("need max_retries >= 0, backoff >= 0, "
                             "backoff_factor >= 1")
        self.engine = engine
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap = float(backoff_cap)
        self.jitter = bool(jitter)
        self._retry_rng = np.random.default_rng(jitter_seed)
        # delays actually waited, in order (the jitter-divergence test's
        # observable: two default-seeded supervisors must NOT share it)
        self.backoff_log: list[float] = []
        self.wave_deadline = wave_deadline
        self.min_deadline = float(min_deadline)
        self.max_deadline = float(max_deadline)
        self.watchdog = bool(watchdog)
        self.degrade = bool(degrade)
        self.sticky_demotions = bool(sticky_demotions)
        self.demotion_slack = float(demotion_slack)
        self._deadline_scale = 1.0
        self.escalate_budget = bool(escalate_budget)
        self.pad_to_plane = bool(pad_to_plane)
        self.timer = timer if timer is not None else StepTimer(k=4.0)
        self.clock = time.monotonic if clock is None else clock
        self.sleep = time.sleep if sleep is None else sleep
        self._supports_budget = supports_budget_override(engine)
        self._tunable = find_tunable_engine(engine)
        if isinstance(integrity, str):
            integrity = IntegrityConfig(mode=integrity)
        self.integrity = integrity
        self._audit_rng = np.random.default_rng(
            None if integrity is None else integrity.seed)
        self._n_integrity_checks = self._n_integrity_violations = 0
        self._n_audits = self._n_audit_failures = 0
        if integrity is not None and integrity.mode != "off":
            self._push_integrity_knobs(integrity)
        self._budget_hint: int | None = None
        self._zombie: threading.Thread | None = None
        self._wave_deadline_override: float | None = None
        self.last_stats: dict = {}
        # lifetime counters (stats() snapshot)
        self._n_waves = self._n_traversals = self._n_fault_waves = 0
        self._n_retries = self._n_timeouts = self._n_bisections = 0
        self._n_budget_escalations = self._n_stragglers = 0
        self._quarantined: list[int] = []
        self._demotions: list[str] = []

    # -- BFSEngine protocol ----------------------------------------------

    @property
    def num_vertices(self) -> int | None:
        return engine_num_vertices(self.engine)

    @property
    def out_deg(self):
        return getattr(self.engine, "out_deg", None)

    def run_batch(self, roots) -> np.ndarray:
        """Strict protocol entry: all-or-error view of a supervised wave.

        Prefer :meth:`run_wave` for per-request outcomes (what
        ``DynamicBatcher`` uses); this raises the first root's typed error
        when any request failed.
        """
        return self.run_wave(roots).levels()

    # -- watchdog deadline ------------------------------------------------

    def current_deadline(self) -> float | None:
        """The deadline the NEXT engine call would get (None = no guard).

        Scaled by ``demotion_slack`` per demotion taken this wave: a
        demoted engine is expected slower, and an unscaled deadline would
        time out the very fallback the ladder just switched to.
        """
        if not self.watchdog:
            return None
        if self._wave_deadline_override is not None:
            # per-wave SLO from the serving layer (run_wave(deadline=)):
            # floored at min_deadline so a nearly-expired SLO still gets
            # one real attempt instead of an instant timeout, and capped
            # by the configured wave_deadline when both are set
            d = max(float(self._wave_deadline_override), self.min_deadline)
            if self.wave_deadline is not None:
                d = min(d, float(self.wave_deadline))
            return d * self._deadline_scale
        if self.wave_deadline is not None:
            return float(self.wave_deadline) * self._deadline_scale
        med = self.timer.median()
        if med is None or len(self.timer.durations) < 3:
            return None               # cold engine: a build is not a hang
        return min(max(self.timer.k * med, self.min_deadline),
                   self.max_deadline) * self._deadline_scale

    # -- the supervised wave ---------------------------------------------

    def run_wave(self, roots,
                 deadline: float | None = None) -> SupervisedWave:
        """Serve a wave of roots under the full fault policy.

        EVERY root resolves: ``outcomes[i]`` carries either its level row
        or a typed error (``WaveTimeout`` / ``WaveAbandoned`` /
        ``RequestQuarantined`` / the original deterministic error for a
        singleton wave).  Never raises for engine failures.

        ``deadline`` (seconds, relative) overrides the watchdog deadline
        for THIS wave only — the serving layer passes the tightest
        remaining request SLO here, so the watchdog enforces it during
        execution (including retries and bisection sub-waves) rather than
        letting a doomed wave run to the statistical deadline.  Requires
        the watchdog to be enabled; floored at ``min_deadline``.
        """
        roots = np.asarray(roots)
        wave = SupervisedWave(
            roots=roots,
            outcomes=[RootOutcome(int(r)) for r in roots])
        snapshot = self._snapshot_knobs()
        self._wave_deadline_override = deadline
        try:
            self._serve(wave, roots, wave.outcomes)
        finally:
            self._wave_deadline_override = None
            if not self.sticky_demotions:
                self._restore_knobs(snapshot)
                self._deadline_scale = 1.0
        self._n_waves += 1
        self._n_traversals += wave.traversals
        self._n_fault_waves += wave.fault_waves
        self._n_retries += wave.retries
        self._n_timeouts += wave.timeouts
        self._n_bisections += wave.bisections
        self._n_budget_escalations += wave.budget_escalations
        self._quarantined.extend(wave.quarantined)
        self._demotions.extend(wave.demotions)
        self.last_stats = dict(wave.stats, ft_traversals=wave.traversals,
                               ft_retries=wave.retries,
                               ft_quarantined=len(wave.quarantined))
        return wave

    def _serve(self, wave: SupervisedWave, roots: np.ndarray,
               outcomes: list[RootOutcome]):
        """Retry-then-bisect policy for one (sub-)wave, resolving every
        outcome in place."""
        tries = 0
        delay = self.backoff
        budget = self._budget_hint
        while True:
            wave.traversals += 1
            try:
                rows, stats, dt = self._attempt(roots, budget)
            except Exception as exc:      # noqa: BLE001 — policy boundary
                wave.fault_waves += 1
                wave.seconds += self._last_attempt_seconds
                if isinstance(exc, IntegrityError):
                    # count every violation ONCE at the policy boundary —
                    # engine-raised (device statvec / witness) and
                    # host-raised (row bounds / popcounts / audit) alike
                    self._n_integrity_violations += 1
                if classify_fault(exc) == DETERMINISTIC:
                    if len(outcomes) == 1:
                        root = outcomes[0].root
                        wave.quarantined.append(root)
                        err = RequestQuarantined(
                            f"root {root} isolated by bisection: "
                            f"{type(exc).__name__}: {exc}")
                        err.__cause__ = exc
                        outcomes[0].error = err
                        return
                    # bisect: isolate the poison in O(log B) sub-waves so
                    # the clean co-batched requests still get answers
                    mid = len(outcomes) // 2
                    wave.bisections += 1
                    self._serve(wave, roots[:mid], outcomes[:mid])
                    self._serve(wave, roots[mid:], outcomes[mid:])
                    return
                # transient fault: retry with backoff, possibly demoted
                if isinstance(exc, WaveTimeout):
                    wave.timeouts += 1
                if is_kernel_fault(exc):
                    wave._kernel_faults += 1
                    if self.degrade and wave._kernel_faults >= 2:
                        demoted = self._demote()
                        if demoted:
                            wave.demotions.append(demoted)
                if (isinstance(exc, BudgetOverflowError)
                        and self.escalate_budget):
                    budget = 2 * max(budget or 0, exc.budget)
                    wave.budget_escalations += 1
                tries += 1
                if tries > self.max_retries:
                    for o in outcomes:
                        if o.error is None and o.levels is None:
                            err = WaveAbandoned(
                                f"wave of {len(outcomes)} roots abandoned "
                                f"after {tries} attempts: "
                                f"{type(exc).__name__}: {exc}")
                            err.__cause__ = exc
                            o.error = err
                    return
                wave.retries += 1
                self.backoff_log.append(delay)
                self._backoff_wait(delay)
                delay = self._next_delay(delay)
            else:
                wave.seconds += dt
                wave.stats = stats
                if (self.escalate_budget
                        and stats.get("overflow_retries", 0) > 0
                        and stats.get("budget", 0) > 0):
                    # the wave deepened mid-flight: start later waves at
                    # the budget it settled on instead of re-deepening
                    self._budget_hint = int(stats["budget"])
                for o, row in zip(outcomes, rows):
                    o.levels = np.ascontiguousarray(row)
                return

    # -- one guarded engine call ------------------------------------------

    def _call_engine(self, slots, budget):
        if budget is not None and self._supports_budget:
            return self.engine.run_batch(slots, budget=int(budget))
        return self.engine.run_batch(slots)

    def _attempt(self, roots: np.ndarray, budget: int | None):
        """One engine traversal with the watchdog armed; pads to plane
        words so bisection sub-waves run the shapes the warm-up ran."""
        slots, b = (bitmap.pad_plane_slots(roots) if self.pad_to_plane
                    else (roots, len(roots)))
        deadline = self.current_deadline()
        self._last_attempt_seconds = 0.0
        t0 = time.perf_counter()
        try:
            if deadline is None:
                levels = self._call_engine(slots, budget)
            else:
                box: dict = {}
                done = threading.Event()

                def work():
                    try:
                        box["levels"] = self._call_engine(slots, budget)
                    except BaseException as e:  # noqa: BLE001
                        box["exc"] = e
                    finally:
                        done.set()

                th = threading.Thread(target=work, daemon=True,
                                      name="supervised-wave")
                th.start()
                if not done.wait(deadline):
                    # abandon: the guard thread may still finish later;
                    # its result is discarded and the next backoff joins it
                    self._zombie = th
                    raise WaveTimeout(
                        f"wave of {len(roots)} roots exceeded the "
                        f"{deadline:.3f}s watchdog deadline")
                if "exc" in box:
                    raise box["exc"]
                levels = box["levels"]
        finally:
            self._last_attempt_seconds = time.perf_counter() - t0
        dt = self._last_attempt_seconds
        if self.timer.record(len(self.timer.durations), dt):
            self._n_stragglers += 1
        stats = dict(getattr(self.engine, "last_stats", {}) or {})
        rows = np.asarray(levels)
        if self.pad_to_plane:
            rows = bitmap.slice_plane_rows(rows, b)
        # integrity validation happens AFTER timer.record: a failed check
        # re-enters _serve as a kernel-class fault, and audit re-runs must
        # not inflate the watchdog's wave-duration history
        if self.integrity is not None and self.integrity.mode != "off":
            self._validate_wave(rows, np.asarray(roots), slots, stats,
                                budget)
        return rows, stats, dt

    def _validate_wave(self, rows: np.ndarray, roots: np.ndarray,
                       slots: np.ndarray, stats: dict,
                       budget: int | None) -> None:
        """Host-side answer validation for one successful attempt; raises
        :class:`IntegrityError` (kernel-class, so _serve retries/demotes).

        Row bounds + root-zero run on every wave (this is the check that
        catches RESULT corruption the in-flight statvec slots cannot see);
        popcount positive-then-terminate runs when the engine recorded the
        sequence; mode ``audit`` additionally re-runs a sampled fraction
        of waves through the reference rung (packed off, else the kernels
        off on a CPU runner) and compares rows exactly.
        """
        self._n_integrity_checks += 1
        check_level_rows(rows, roots, stats.get("iterations"))
        pcs = stats.get("discovery_popcounts")
        if pcs is not None:
            check_popcount_sequence(pcs)
        if (self.integrity.mode == "audit"
                and self._audit_rng.random() < self.integrity.audit_rate):
            self._differential_audit(rows, slots, budget)

    def _differential_audit(self, rows: np.ndarray, slots: np.ndarray,
                            budget: int | None) -> None:
        """Re-run the padded wave through the reference rung and compare.

        Talks to the TUNABLE runner directly (not ``self.engine``): a
        chaos wrapper in between would advance its fault schedule and
        could inject into the reference itself.  Knobs are restored even
        when the audit raises.

        On a packed engine the reference rung is ``packed=False`` (on the
        card: the bool-plane engine with K3).  On a CPU bool-plane engine
        with the kernels on it is ``use_kernels=False``.  A bool-plane
        engine on the card has no rung left that the card may run, so the
        audit returns there, as it does on the reference rung itself.
        """
        t = self._tunable
        if t is None:
            return
        d = getattr(t, "__dict__", {})
        knob = ("packed" if d.get("packed", False)
                else "use_kernels" if (d.get("use_kernels", False)
                                       and not on_card(t)) else None)
        if knob is None:
            return            # already ON the reference rung: nothing to diff
        self._n_audits += 1
        saved = getattr(t, knob)
        try:
            setattr(t, knob, False)
            ref = np.asarray(self._call_tunable(t, slots, budget))
            ref = bitmap.slice_plane_rows(ref, rows.shape[0])
        finally:
            setattr(t, knob, saved)
        if not np.array_equal(ref, rows):
            self._n_audit_failures += 1
            bad = int(np.sum(np.any(ref != rows, axis=1)))
            raise IntegrityError(
                f"differential audit mismatch: {bad}/{rows.shape[0]} "
                f"planes differ from the {knob}=False reference")

    @staticmethod
    def _call_tunable(t, slots, budget):
        if budget is not None and supports_budget_override(t):
            return t.run_batch(slots, budget=int(budget))
        return t.run_batch(slots)

    def _push_integrity_knobs(self, cfg: IntegrityConfig) -> None:
        """Configure ENGINE-side checking on the tunable runner: statvec
        invariant slot + (witness/audit) the sampled witness reduction.
        No-op for engines without the knobs (e.g. DistributedBFS) — the
        host-side checks in :meth:`_validate_wave` still apply."""
        t = self._tunable
        if t is None or "integrity" not in getattr(t, "__dict__", {}):
            return
        t.integrity = cfg.mode
        t.witness_k = cfg.witness_k
        t.witness_budget = cfg.witness_budget

    def _next_delay(self, delay: float) -> float:
        """Next retry delay: plain exponential when ``jitter=False``,
        decorrelated jitter (``uniform(backoff, 3 x delay)``, capped at
        ``backoff_cap``) otherwise — correlated faults across pool
        workers then spread their retries instead of re-colliding."""
        if not self.jitter:
            return delay * self.backoff_factor
        hi = max(3.0 * delay, self.backoff)
        return min(self.backoff_cap,
                   float(self._retry_rng.uniform(self.backoff, hi)))

    def _backoff_wait(self, delay: float):
        """Back off before a retry; if a timed-out wave's guard thread is
        still running, spend the backoff joining it (keeps the engine from
        seeing two concurrent waves in the common case)."""
        z = self._zombie
        if z is not None and z.is_alive():
            z.join(delay if delay > 0 else None)
        elif delay > 0:
            self.sleep(delay)
        if z is not None and not z.is_alive():
            self._zombie = None

    # -- degradation ladder ----------------------------------------------

    def _snapshot_knobs(self) -> dict:
        t = self._tunable
        if t is None:
            return {}
        return {k: getattr(t, k) for k in ("use_kernels", "packed")
                if k in getattr(t, "__dict__", {})}

    def _restore_knobs(self, snapshot: dict):
        for k, v in snapshot.items():
            setattr(self._tunable, k, v)

    def _demote(self) -> str | None:
        """Step the engine one rung down the ladder; returns the demotion
        label, or None when the bottom is reached / nothing is tunable.

        A CUDA runner keeps ``use_kernels`` on: its one demotion sets
        ``packed=False`` and, passing over the torch rung, scales the
        deadline once for each rung."""
        t = self._tunable
        if t is None:
            return None
        card = on_card(t)
        if getattr(t, "use_kernels", False) and not card:
            t.use_kernels = False
            self._deadline_scale *= self.demotion_slack
            return "kernels->torch"
        if getattr(t, "packed", False):
            t.packed = False
            if card:
                self._deadline_scale *= self.demotion_slack ** 2
                return "kernels->boolplane"
            self._deadline_scale *= self.demotion_slack
            return "packed->boolplane"
        return None

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime supervisor counters (JSON-friendly)."""
        out = dict(
            waves=self._n_waves, traversals=self._n_traversals,
            fault_waves=self._n_fault_waves, retries=self._n_retries,
            timeouts=self._n_timeouts, bisections=self._n_bisections,
            budget_escalations=self._n_budget_escalations,
            stragglers=self._n_stragglers,
            quarantined=list(self._quarantined),
            demotions=list(self._demotions),
        )
        dl = self.current_deadline()
        if dl is not None:
            out["wave_deadline"] = round(float(dl), 4)
        if self._budget_hint is not None:
            out["budget_hint"] = int(self._budget_hint)
        if self.integrity is not None:
            out["integrity"] = dict(
                mode=self.integrity.mode,
                checks=self._n_integrity_checks,
                violations=self._n_integrity_violations,
                audits=self._n_audits,
                audit_failures=self._n_audit_failures)
        return out


# ---------------------------------------------------------------------------
# Deterministic chaos harness
# ---------------------------------------------------------------------------

FAULT_KINDS = ("kernel", "runtime", "stuck", "plane_flip", "result_flip")


class FaultPlan:
    """Exact-once (engine-call index -> fault kind) schedule.

    The index counts ENGINE CALLS at the supervised boundary — retries and
    bisection sub-waves advance it too, so a schedule pins faults to a
    reproducible point of the serving run regardless of wall clock.
    """

    def __init__(self, faults=()):
        self._faults: dict[int, str] = {}
        for idx, kind in faults:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; have {FAULT_KINDS}")
            if int(idx) in self._faults:
                raise ValueError(f"duplicate fault at wave index {idx}")
            self._faults[int(idx)] = kind
        self.injected: list[tuple[int, str]] = []

    @classmethod
    def random(cls, horizon: int, rate: float, *,
               kinds=("kernel", "runtime"), seed: int = 0) -> "FaultPlan":
        """Bernoulli(rate) fault per wave index over ``horizon`` calls,
        cycling through ``kinds`` — deterministic given ``seed``."""
        rng = np.random.default_rng(seed)
        hits = np.flatnonzero(rng.random(int(horizon)) < rate)
        return cls([(int(i), kinds[k % len(kinds)])
                    for k, i in enumerate(hits)])

    def pop(self, idx: int) -> str | None:
        kind = self._faults.pop(int(idx), None)
        if kind is not None:
            self.injected.append((int(idx), kind))
        return kind

    def pending(self) -> dict[int, str]:
        return dict(self._faults)

    def __len__(self) -> int:
        return len(self._faults)


class FaultyEngine:
    """BFSEngine-protocol chaos test double wrapping a real engine.

    Injects, at the engine boundary the supervisor guards:

    * plan-scheduled faults — ``kernel`` raises :class:`KernelFault`,
      ``runtime`` raises :class:`InjectedFailure`, ``stuck`` stalls
      ``stall_seconds`` before serving (tripping the watchdog when the
      deadline is shorter);
    * poisoned roots — any wave containing one raises
      :class:`PoisonedRoot` (deterministic, every time), which the
      supervisor isolates by bisection;
    * ``break_kernels=True`` — raises :class:`KernelFault` whenever the
      underlying engine still has ``use_kernels`` enabled, emulating a
      broken kernel toolchain until the ladder demotes to the plain torch
      path (a CPU runner; on the card every rung runs kernels, so the
      wave is abandoned there);
    * bit-flip corruption (SILENT faults — nothing raises; only the
      integrity layer can catch them): ``plane_flip`` arms the runner's
      exact-once ``_corrupt_plane`` hook, XOR-ing one frontier plane bit
      mid-traversal at (level, vertex, plane) — ``plane_flip=`` pins the
      target, otherwise it derives deterministically from the call index;
      ``result_flip`` XORs one bit of the RETURNED level rows at
      (row, vertex, bit) after the inner engine finished (``result_flip=``
      pins it; bit defaults to 16 so any level or INF lands outside the
      valid range and the row-bounds check must fire).  Every flip is
      recorded in ``self.flips``.

    The inner engine is called under a lock so a timed-out (zombie) wave
    finishing late never overlaps a retry's traversal.
    """

    def __init__(self, inner, plan: FaultPlan | None = None, *,
                 poisoned_roots=(), stall_seconds: float = 0.25,
                 break_kernels: bool = False,
                 plane_flip: tuple[int, int, int] | None = None,
                 result_flip: tuple[int, int, int] | None = None,
                 sleep=None):
        self.inner = inner
        self.plan = plan if plan is not None else FaultPlan()
        self.poisoned = {int(r) for r in poisoned_roots}
        self.stall_seconds = float(stall_seconds)
        self.break_kernels = bool(break_kernels)
        self.plane_flip = plane_flip
        self.result_flip = result_flip
        self.flips: list[dict] = []
        self.sleep = time.sleep if sleep is None else sleep
        self.calls = 0
        self._lock = threading.Lock()
        self._supports_budget = supports_budget_override(inner)

    # protocol passthrough
    @property
    def num_vertices(self):
        return engine_num_vertices(self.inner)

    @property
    def out_deg(self):
        return getattr(self.inner, "out_deg", None)

    @property
    def last_stats(self):
        return getattr(self.inner, "last_stats", {})

    def run_batch(self, roots, *, budget: int | None = None) -> np.ndarray:
        idx = self.calls
        self.calls += 1
        hit = self.poisoned.intersection(int(r) for r in np.asarray(roots))
        if hit:
            raise PoisonedRoot(
                f"poisoned root(s) {sorted(hit)} in wave {idx}")
        tunable = find_tunable_engine(self.inner)
        if self.break_kernels and getattr(tunable, "use_kernels", False):
            raise KernelFault(
                f"kernel build failed at wave {idx} (break_kernels)")
        kind = self.plan.pop(idx)
        if kind == "kernel":
            raise KernelFault(f"injected kernel fault at wave {idx}")
        if kind == "runtime":
            raise InjectedFailure(f"injected runtime fault at wave {idx}")
        if kind == "stuck":
            self.sleep(self.stall_seconds)
        if kind == "plane_flip":
            spec = self.plane_flip or (
                1 + idx % 2,
                (1103515245 * idx + 7) % max(1, self.num_vertices or 1),
                idx % max(1, len(np.asarray(roots))))
            if tunable is not None and hasattr(tunable, "_corrupt_plane"):
                tunable._corrupt_plane = tuple(int(x) for x in spec)
                self.flips.append(dict(wave=idx, kind=kind,
                                       target=list(spec)))
        with self._lock:
            if budget is not None and self._supports_budget:
                rows = self.inner.run_batch(roots, budget=budget)
            else:
                rows = self.inner.run_batch(roots)
        if tunable is not None and getattr(tunable, "_corrupt_plane",
                                           None) is not None:
            # the target level was never reached (or the engine is not a
            # packed runner): disarm so the flip cannot leak into a later,
            # unscheduled wave
            tunable._corrupt_plane = None
        if kind == "result_flip":
            rows = np.array(rows)            # corrupt a COPY, post-engine
            r, v, bit = self.result_flip or (
                idx % rows.shape[0],
                (1103515245 * idx + 13) % rows.shape[1], 16)
            rows[int(r) % rows.shape[0],
                 int(v) % rows.shape[1]] ^= np.int32(1 << int(bit))
            self.flips.append(dict(wave=idx, kind=kind,
                                   target=[int(r), int(v), int(bit)]))
        return rows
