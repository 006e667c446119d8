"""Asynchronous dynamic-batching driver for MS-BFS query serving (PyTorch
port of ``repro.launch.dynbatch``; host Python over the ``BFSEngine``
protocol, so the engine may live on the CUDA card or on the CPU).

ScalaBFS earns its throughput by keeping all 32 HBM pseudo-channels busy
with concurrent work; the software analogue is the MS-BFS engine, where one
traversal of the device-resident graph answers a whole batch of queries
(one bit-plane per source).  That engine only helps if queries actually
arrive batched — a stream of independent single-root requests gets none of
the ~21x batch-32 win.  This module closes that gap (the ROADMAP's
"dynamic batching for ``bfs_batch`` serving" item):

* ``DynamicBatcher.submit(root) -> BFSFuture`` enqueues one query and
  returns immediately.  ``submit(root, deadline=, priority=)`` attaches an
  SLO: waves are cut urgency-first (priority tier, then oldest deadline)
  and a wave is cut EARLY when the tightest pending deadline is about to
  become unmeetable (``slo_margin``); per-wave SLO misses are accounted in
  :class:`WaveStats` and ``stats()``.
* A wave scheduler coalesces every request that arrived within a
  configurable ``window`` (or up to ``max_batch`` — any multiple of the
  32-bit plane word runs as a MULTI-WORD wave, e.g. ``max_batch=96`` is
  three plane words) into a SINGLE MS-BFS wave: the roots are packed into
  plane slots (padded to a whole word so the step shapes stay the ones
  the warm-up ran, see ``bitmap.pad_plane_slots``), dispatched through
  ``run``/``run_batch``, and each future resolves with its own level
  vector, its queue latency, and the wave's aggregate-TEPS stats.
* ``pipeline=True`` (threaded mode) splits dispatch into three stages —
  CUTTER (cut + validate + pad wave N+1 on host), DISPATCHER (the only
  stage that touches the engine), FINISHER (slice rows, resolve futures,
  book stats) — connected by bounded queues, so the engine never idles on
  host-side wave assembly or result bookkeeping under a saturating
  stream.  Engine idle between consecutive waves is measured and reported
  (``stats()["engine_idle_seconds"]``).  Each stage's work on a wave is a
  ``repro_torch.trace`` span (``batcher.cut`` / ``.execute`` /
  ``.finish``, args: the wave's cut sequence number), so a profiler that
  records every thread shows the three threads' share of each wave.
* Time is injected (``clock=``): with the default ``time.monotonic`` a
  daemon worker thread drives waves; with a fake clock the scheduler is a
  deterministic, single-threaded state machine driven by ``pump()`` /
  ``flush()`` — what the tests use.
* Backpressure: the request queue is bounded (``max_pending``); ``submit``
  blocks (threaded mode) or raises ``QueueFull``.  ``close(drain=True)``
  flushes every pending request into final waves before shutting down.
* Admission control (``shed=True``): a deadline request whose estimated
  queue delay (EWMA wave service x waves of backlog ahead) already
  exceeds its SLO is refused synchronously with a typed ``Overloaded`` —
  it fails in well under one wave time instead of burning engine time on
  a guaranteed miss and dragging every queued request later.
* Fault tolerance: hand the batcher an ``repro_torch.ft.EngineSupervisor``
  (wrapping the real engine) and the worker loop delegates its WHOLE
  failure policy to it — watchdog deadlines, typed retry with backoff,
  quarantine bisection of poisoned roots, and the kernel degradation
  ladder.  Every future then resolves with either its levels or a typed
  error from the ``repro_torch.ft`` taxonomy (``WaveTimeout`` /
  ``WaveAbandoned`` / ``RequestQuarantined``); nothing hangs and nothing
  retries unboundedly.  A wave carrying request deadlines passes the
  tightest remaining one to ``run_wave(deadline=)`` so the watchdog
  enforces the SLO during execution, not just at cut time.  Without a
  supervisor the legacy policy applies: a deterministic (input-shaped)
  dispatch error isolates per-request with a hard cap of ONE singleton
  retry per request, and transient errors fail the wave's futures
  immediately.

Works in front of any engine ``launch.serve.build_engine`` returns (the
local ``MultiSourceBFSRunner`` and the CC / SSSP runners).  For a pool of
engines behind one submit surface see ``launch.pool``.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque

import numpy as np

from repro_torch.core import (bitmap, count_traversed_edges,
                              engine_num_vertices, validate_roots)
from repro_torch.ft.supervisor import (DETERMINISTIC, EngineSupervisor,
                                       classify_fault)
from repro_torch.trace import span


class QueueFull(RuntimeError):
    """Bounded request queue at capacity (backpressure signal)."""


class BatcherClosed(RuntimeError):
    """submit() after close() began, or result() of a cancelled request."""


class Overloaded(RuntimeError):
    """Admission control shed this request: the estimated queue delay
    (EWMA wave service time x waves of backlog ahead) already exceeds the
    request's deadline, so serving it would burn engine time on a
    guaranteed SLO miss.  Raised synchronously by ``submit`` — a shed
    request fails in well under one wave service time, leaving the engine
    to the requests that can still make their deadlines."""


@dataclasses.dataclass
class WaveStats:
    """One dispatched MS-BFS wave (shared by every future it resolved)."""

    wave_id: int
    batch: int                  # real requests served
    n_slots: int                # plane slots actually run (padded)
    t_start: float              # injected-clock time the wave was cut
    seconds: float              # service time (wall clock, traversal only)
    iterations: int
    edges_inspected: int
    push_iters: int
    pull_iters: int
    traversed_edges: int | None  # paper §VI-A metric over the REAL requests
    latencies: list[float] = dataclasses.field(default_factory=list)
    error: str | None = None    # set when the WHOLE wave failed
    # SLO accounting (requests submitted with deadline=)
    deadline_requests: int = 0  # requests in this wave that carried an SLO
    slo_misses: int = 0         # of those: resolved late or with an error
    preempted: bool = False     # wave cut early to protect a deadline
    # fault-tolerance accounting (supervised waves; zero on the legacy path)
    failed: int = 0             # requests resolved with a typed error
    traversals: int = 0         # engine calls incl. retries + bisection
    retries: int = 0
    timeouts: int = 0
    quarantined: list[int] = dataclasses.field(default_factory=list)
    demotions: list[str] = dataclasses.field(default_factory=list)
    # injected-clock times of the wave's engine entry and of the engine's
    # return (or raise): t_dispatch - t_start is the wait behind earlier
    # waves, t_engine_done - t_dispatch the engine call
    t_dispatch: float | None = None
    t_engine_done: float | None = None

    @property
    def aggregate_teps(self) -> float | None:
        if self.traversed_edges is None:
            return None
        return self.traversed_edges / max(self.seconds, 1e-12)


class BFSFuture:
    """Handle for one submitted query; resolves when its wave completes."""

    def __init__(self, root: int, t_submit: float,
                 t_deadline: float | None = None, priority: int = 0):
        self.root = int(root)
        self.t_submit = float(t_submit)
        # ABSOLUTE injected-clock deadline (t_submit + relative SLO)
        self.t_deadline = None if t_deadline is None else float(t_deadline)
        self.priority = int(priority)
        self.wave: WaveStats | None = None
        self.latency: float | None = None   # injected-clock submit->resolve
        self.slo_miss: bool | None = None   # None: no deadline was set
        self._seq = 0                       # submit order (stable sort key)
        self._event = threading.Event()
        self._levels = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        """True once the future resolved — with levels OR a typed error.
        Poll with :meth:`exception` to see which without raising."""
        return self._event.is_set()

    def exception(self, timeout: float | None = 0) -> BaseException | None:
        """The typed error this request resolved with, without raising.

        Returns None while the request is still pending (disambiguate with
        :meth:`done`) or when it succeeded.  ``timeout`` bounds how long to
        wait for resolution (default 0: pure poll).
        """
        self._event.wait(timeout)
        return self._exc

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Level vector int64-compatible [|V|] for this root's traversal.

        A future whose wave was abandoned/quarantined raises its typed
        error (``repro_torch.ft`` taxonomy) as soon as the wave resolves it —
        never blocking out the full ``timeout``.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"BFS query for root {self.root} not served in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._levels

    def _resolve(self, levels, wave: WaveStats, latency: float):
        self._levels = levels
        self.wave = wave
        self.latency = latency
        self._event.set()

    def _fail(self, exc: BaseException):
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class _Prepared:
    """Cutter-stage output: a cut wave, validated and padded on host.

    Everything the engine call needs, assembled BEFORE the engine is
    touched — under ``pipeline=True`` this happens while the previous
    wave is still traversing.
    """

    futures: list[BFSFuture]
    slots: np.ndarray           # padded plane slots handed to the engine
    b: int                      # real request count
    ws: WaveStats
    seq: int                    # cut order: the stage spans' args


@dataclasses.dataclass
class _Executed:
    """Dispatcher-stage output: one engine call's raw outcome."""

    prep: _Prepared
    levels: np.ndarray | None = None    # legacy path success
    wave: object | None = None          # SupervisedWave (supervised path)
    exc: BaseException | None = None
    # legacy deterministic isolate-retry: the parent wave's futures were
    # re-dispatched as singleton waves, which own their resolution — the
    # parent _Executed books its error wave but resolves nobody
    futures_owned_elsewhere: bool = False


class DynamicBatcher:
    """Coalesce single-root BFS queries into MS-BFS waves.

    Wave-cut rule: a wave dispatches as soon as ``max_batch`` requests are
    pending, when the OLDEST pending request has waited ``window`` seconds,
    or when the tightest pending deadline is within ``slo_margin`` of
    becoming unmeetable — whichever comes first.  An idle stream pays at
    most one window of queueing delay, a hot stream always runs full plane
    words, and an urgent request can preempt the window.

    ``max_batch`` may span several plane words (``W x 32``): the wave pads
    to whole words and the engine runs one multi-word traversal.

    ``clock=None`` (default) runs a daemon worker thread on real time.
    Passing a callable clock disables the thread: the scheduler becomes a
    deterministic state machine — advance the fake clock yourself and call
    :meth:`pump` (one due wave) or :meth:`flush` (everything, deadlines
    ignored).  ``start`` overrides the thread choice explicitly.

    ``pipeline=True`` (threaded mode only) runs the cutter / dispatcher /
    finisher stages on separate threads with bounded hand-off queues so
    host-side wave assembly and result bookkeeping overlap the engine's
    traversal instead of serializing with it.
    """

    def __init__(self, engine, *, out_deg: np.ndarray | None = None,
                 window: float = 0.02, max_batch: int = 32,
                 max_pending: int = 1024, clock=None,
                 pad_to_plane: bool = True, start: bool | None = None,
                 stats_history: int = 4096, pipeline: bool = False,
                 pipeline_depth: int = 2, slo_margin: float | None = None,
                 shed: bool = False, service_hint: float | None = None,
                 failure_handler=None):
        if max_batch < 1 or max_pending < 1 or window < 0:
            raise ValueError("need max_batch >= 1, max_pending >= 1, "
                             "window >= 0")
        if pipeline_depth < 1:
            raise ValueError("need pipeline_depth >= 1")
        if service_hint is not None and service_hint < 0:
            raise ValueError(f"service_hint must be >= 0, got {service_hint}")
        self.engine = engine
        # admission control: shed=True makes submit() raise Overloaded when
        # the estimated queue delay already exceeds the request's deadline.
        # service_hint primes the EWMA service estimate so the very first
        # waves aren't admitted blind (the estimate is 0 until a wave ran).
        self.shed = bool(shed)
        # pool hook: failure_handler(future, exc) -> bool runs for each
        # future about to FAIL with an engine-side error.  Returning True
        # hands ownership of the future to the handler (the pool
        # redispatches it to a surviving worker); this batcher then skips
        # its resolution and latency/SLO booking — the worker that finally
        # resolves it books the full submit->resolve latency.
        self.failure_handler = failure_handler
        # an EngineSupervisor engine moves the whole failure policy (typed
        # retries, watchdog, bisection, degradation) out of this worker
        # loop: _dispatch delegates to supervisor.run_wave per-request
        self.supervisor = engine if isinstance(engine, EngineSupervisor) \
            else None
        self.window = float(window)
        self.max_batch = int(max_batch)
        self.max_pending = int(max_pending)
        self.pad_to_plane = bool(pad_to_plane)
        # how long before an SLO deadline a wave must be cut for the
        # request to stand a chance; None tracks an EWMA of recent wave
        # service times measured on the injected clock (0 until a wave ran)
        self.slo_margin = None if slo_margin is None else float(slo_margin)
        # BFSEngine protocol: every engine exposes num_vertices, out_deg
        # and run_batch (engine_num_vertices keeps a .g/.pg fallback for
        # older wrappers; engines without out_deg just lose TEPS stats)
        self.num_vertices = engine_num_vertices(engine)
        if out_deg is None:
            out_deg = getattr(engine, "out_deg", None)
        self.out_deg = None if out_deg is None else np.asarray(out_deg)
        self.clock = time.monotonic if clock is None else clock
        # waves history is bounded: a long-running server must not grow
        # without limit.  Percentiles cover the retained window; the
        # counters below keep the totals exact forever.
        self.waves: deque[WaveStats] = deque(maxlen=stats_history)
        self._n_waves = self._n_errors = 0
        self._n_requests = 0              # requests in error-free waves
        self._n_failed = 0                # requests resolved w/ typed error
        self._n_slo_requests = 0          # lifetime requests with deadlines
        self._n_slo_misses = 0
        self._busy_seconds = 0.0          # engine-occupied (incl. failures)
        self._idle_seconds = 0.0          # engine gaps between waves
        self._last_exec_end: float | None = None
        # EWMA wave service (injected clock); primed by service_hint
        self._service_est = float(service_hint or 0.0)
        self._service_primed = service_hint is not None
        self._n_shed = 0                  # requests refused by admission
        # consecutive waves that failed for ENGINE reasons (quarantine-only
        # waves don't count: poisoned input, healthy engine).  The pool's
        # health state machine reads this to drive SUSPECT/EVICTED.
        self.consecutive_failures = 0
        self._traversed = 0
        self._inflight = 0                # cut but not yet finished
        self._seq = 0
        self._cut_seq = itertools.count()  # waves in the order they are cut
        self._pending: deque[BFSFuture] = deque()
        self._n_slo_pending = 0           # pending with deadline/priority
        self._cond = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None
        self._dispatch_thread: threading.Thread | None = None
        self._finish_thread: threading.Thread | None = None
        threaded = (clock is None) if start is None else bool(start)
        self.pipeline = bool(pipeline)
        if self.pipeline and not threaded:
            raise ValueError(
                "pipeline=True needs the threaded worker (real clock or "
                "start=True); fake-clock pump()/flush() are synchronous")
        if self.pipeline:
            # bounded hand-off: the cutter preps at most pipeline_depth
            # waves ahead of the engine, the finisher queue is unbounded
            # (resolution must never stall the engine)
            self._dispatch_q: queue.Queue = queue.Queue(
                maxsize=int(pipeline_depth))
            self._finish_q: queue.Queue = queue.Queue()
            self._dispatch_thread = threading.Thread(
                target=self._pipeline_dispatcher, name="dynbatch-dispatch",
                daemon=True)
            self._finish_thread = threading.Thread(
                target=self._pipeline_finisher, name="dynbatch-finish",
                daemon=True)
            self._dispatch_thread.start()
            self._finish_thread.start()
        if threaded:
            self._thread = threading.Thread(
                target=self._worker, name="dynbatch-worker", daemon=True)
            self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, root: int, *, block: bool = True,
               timeout: float | None = None, deadline: float | None = None,
               priority: int = 0) -> BFSFuture:
        """Enqueue one BFS query; returns a :class:`BFSFuture`.

        ``deadline`` is an SLO in RELATIVE seconds (injected clock): the
        request wants its result within that long of submission.  Waves
        are cut urgency-first and may be cut early to protect a deadline;
        whether each deadline was met is accounted per wave and in
        ``stats()`` (``slo_miss_rate``).  ``priority`` breaks ties before
        deadlines — lower runs first (default 0).

        Raises ``ValueError`` for an out-of-range root, ``QueueFull`` when
        the bounded queue stays at capacity (immediately if ``block=False``
        or no worker thread runs to drain it), ``BatcherClosed`` after
        :meth:`close`.
        """
        if not isinstance(root, (int, np.integer)):
            # reject rather than truncate, matching validate_roots
            raise ValueError(
                f"root must be an integer, got {type(root).__name__}")
        root = int(root)
        if self.num_vertices is not None:
            validate_roots(np.asarray([root]), self.num_vertices)
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        with self._cond:
            if self._closed:
                raise BatcherClosed("submit() on a closed DynamicBatcher")
            if (self.shed and deadline is not None
                    and self._estimated_delay_locked() > deadline):
                self._n_shed += 1
                raise Overloaded(
                    f"estimated queue delay "
                    f"{self._estimated_delay_locked():.4f}s exceeds the "
                    f"request deadline {deadline:.4f}s "
                    f"(backlog={len(self._pending) + self._inflight}, "
                    f"service_est={self._service_est:.4f}s)")
            # backpressure: blocking waits only help when a worker thread
            # is draining the queue concurrently.  The timeout runs on the
            # INJECTED clock — a fake-clock batcher with start=True times
            # out when the fake clock passes the deadline, not wall time.
            can_wait = block and self._thread is not None
            t_quit = None if timeout is None else self.clock() + timeout
            while len(self._pending) >= self.max_pending:
                if not can_wait:
                    raise QueueFull(
                        f"{len(self._pending)} requests pending "
                        f"(max_pending={self.max_pending})")
                if t_quit is not None:
                    wait = t_quit - self.clock()
                    if wait <= 0:
                        raise QueueFull(f"queue still full after {timeout}s")
                    self._cond.wait(wait)
                else:
                    self._cond.wait()
                if self._closed:
                    raise BatcherClosed(
                        "submit() on a closed DynamicBatcher")
            t_sub = self.clock()
            fut = BFSFuture(root, t_sub,
                            None if deadline is None else t_sub + deadline,
                            priority)
            fut._seq = self._seq
            self._seq += 1
            self._pending.append(fut)
            if fut.t_deadline is not None or fut.priority != 0:
                self._n_slo_pending += 1
            self._cond.notify_all()
        return fut

    def _estimated_delay_locked(self) -> float:
        """Expected submit->resolve delay for a request admitted NOW:
        EWMA wave service time x (this wave + the waves of backlog queued
        ahead of it).  0 until a wave has run (or ``service_hint`` primed
        the estimate) — admission control never rejects blind."""
        backlog = len(self._pending) + self._inflight
        return self._service_est * (1.0 + backlog / self.max_batch)

    def estimated_delay(self) -> float:
        """Thread-safe :meth:`_estimated_delay_locked` (pool routing)."""
        with self._cond:
            return self._estimated_delay_locked()

    def _submit_future(self, fut: BFSFuture) -> None:
        """Enqueue an EXISTING future (pool redispatch after an eviction).

        Preserves the future's original ``t_submit`` / deadline / priority
        so its eventual latency and SLO verdict span the whole journey,
        not just the surviving worker's share.  Non-blocking: raises
        ``BatcherClosed`` / ``QueueFull`` so the caller can try the next
        worker instead of deadlocking inside a finisher thread.
        """
        with self._cond:
            if self._closed:
                raise BatcherClosed(
                    "redispatch onto a closed DynamicBatcher")
            if len(self._pending) >= self.max_pending:
                raise QueueFull(
                    f"{len(self._pending)} requests pending "
                    f"(max_pending={self.max_pending})")
            fut._seq = self._seq
            self._seq += 1
            self._pending.append(fut)
            if fut.t_deadline is not None or fut.priority != 0:
                self._n_slo_pending += 1
            self._cond.notify_all()

    def cancel_pending(self) -> list[BFSFuture]:
        """Pop every queued (not yet cut) request WITHOUT resolving it.

        Eviction support: the pool drains a failing worker's queue and
        redispatches the futures to survivors.  The caller owns the
        returned futures — anything it cannot place must be failed
        explicitly or clients hang.
        """
        with self._cond:
            out = list(self._pending)
            self._pending.clear()
            self._n_slo_pending = 0
            self._cond.notify_all()    # free queue capacity for waiters
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler --------------------------------------------------------

    def _slo_margin_locked(self) -> float:
        return (self._service_est if self.slo_margin is None
                else self.slo_margin)

    def _deadline_locked(self) -> float | None:
        """Injected-clock time the next wave must be cut: the window of the
        oldest request, or earlier when a pending SLO deadline (minus the
        cut margin) preempts it."""
        if not self._pending:
            return None
        cut = self._pending[0].t_submit + self.window
        if self._n_slo_pending:
            margin = self._slo_margin_locked()
            for f in self._pending:
                if f.t_deadline is not None:
                    cut = min(cut, f.t_deadline - margin)
        return cut

    def _cut_wave_locked(self) -> list[BFSFuture]:
        """Pop the next wave: FIFO normally; urgency-first — (priority,
        oldest deadline, arrival) — when any pending request carries an
        SLO, so a late urgent request still makes the next wave."""
        k = min(self.max_batch, len(self._pending))
        if self._n_slo_pending == 0:
            wave = [self._pending.popleft() for _ in range(k)]
        else:
            ordered = sorted(
                self._pending,
                key=lambda f: (f.priority,
                               np.inf if f.t_deadline is None
                               else f.t_deadline, f._seq))
            wave = ordered[:k]
            taken = {id(f) for f in wave}
            self._pending = deque(
                f for f in self._pending if id(f) not in taken)
            self._n_slo_pending = sum(
                1 for f in self._pending
                if f.t_deadline is not None or f.priority != 0)
        self._inflight += len(wave)
        self._cond.notify_all()        # free queue capacity
        return wave

    def _try_cut_locked(self, force: bool = False
                        ) -> tuple[list[BFSFuture], bool] | None:
        """Cut the next wave if one is due; returns (futures, preempted)."""
        if not self._pending:
            return None
        full = len(self._pending) >= self.max_batch
        cut_at = self._deadline_locked()
        now = self.clock()
        if not (force or full or now >= cut_at):
            return None
        # preempted: cut before the window expired and before filling up,
        # purely to protect an SLO deadline
        preempted = (not force and not full
                     and now < self._pending[0].t_submit + self.window)
        return self._cut_wave_locked(), preempted

    def pump(self, force: bool = False) -> WaveStats | None:
        """Dispatch at most one due wave (manual / fake-clock mode).

        A wave is due when ``max_batch`` requests are pending, the oldest
        has aged past ``window``, or an SLO deadline preempts the window
        (``force=True`` ignores all deadlines).  Returns its
        :class:`WaveStats`, or None if nothing was due.
        """
        with self._cond:
            cut = self._try_cut_locked(force)
            if cut is None:
                return None
            wave, preempted = cut
        return self._dispatch(wave, preempted)

    def flush(self) -> list[WaveStats]:
        """Dispatch ALL pending requests now, deadlines ignored."""
        out = []
        while True:
            w = self.pump(force=True)
            if w is None:
                return out
            out.append(w)

    def close(self, drain: bool = True, timeout: float | None = None):
        """Stop accepting requests; serve (``drain=True``) or cancel what
        is still queued.  Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            if not drain:
                cancelled = list(self._pending)
                self._pending.clear()
                self._n_slo_pending = 0
            self._cond.notify_all()
        if not drain:
            for f in cancelled:
                f._fail(BatcherClosed("request cancelled by close()"))
        had_thread = self._thread is not None
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():   # keep the handle: not drained
                raise TimeoutError(
                    f"worker still draining after {timeout}s")
            self._thread = None
        if self._dispatch_thread is not None:
            # cutter is done: run the pipeline dry, in stage order
            self._dispatch_q.put(None)
            self._dispatch_thread.join(timeout)
            if self._dispatch_thread.is_alive():
                raise TimeoutError(
                    f"dispatcher still draining after {timeout}s")
            self._dispatch_thread = None
            self._finish_q.put(None)
            self._finish_thread.join(timeout)
            if self._finish_thread.is_alive():
                raise TimeoutError(
                    f"finisher still draining after {timeout}s")
            self._finish_thread = None
        elif drain and not already and not had_thread:
            self.flush()

    def backlog(self) -> int:
        """Queued + cut-but-unfinished requests (pool routing signal)."""
        with self._cond:
            return len(self._pending) + self._inflight

    def _worker(self):
        """Cutter loop (real-clock mode): wait for the window deadline, a
        full wave or an SLO preemption; cut; dispatch (or hand to the
        pipeline); repeat.  Drains the queue on close."""
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:        # closed and drained
                    return
                cut = self._try_cut_locked(force=self._closed)
                if cut is None:
                    self._cond.wait(
                        max(self._deadline_locked() - self.clock(), 0.0))
                    continue
                wave, preempted = cut
            if self.pipeline:
                # prepare on THIS thread (cutter stage), then hand off;
                # put() blocks when pipeline_depth waves are already
                # prepped — natural backpressure on the cutter
                self._dispatch_q.put(self._prepare(wave, preempted))
            else:
                self._dispatch(wave, preempted)

    def _pipeline_dispatcher(self):
        """Dispatcher stage: the ONLY thread that touches the engine."""
        while True:
            prep = self._dispatch_q.get()
            if prep is None:
                return
            self._finish_q.put(self._execute(prep))

    def _pipeline_finisher(self):
        """Finisher stage: slice rows, resolve futures, book stats."""
        while True:
            ex = self._finish_q.get()
            if ex is None:
                return
            self._finish(ex)

    # -- dispatch stages --------------------------------------------------

    def _dispatch(self, futures: list[BFSFuture],
                  preempted: bool = False) -> WaveStats:
        """Synchronous dispatch: the three stages back-to-back (manual
        pump/flush mode and the non-pipelined worker)."""
        execs = self._execute(self._prepare(futures, preempted))
        return self._finish(execs)

    def _prepare(self, futures: list[BFSFuture],
                 preempted: bool = False) -> _Prepared:
        """Cutter stage: validate + pad the wave, before the engine."""
        seq = next(self._cut_seq)
        with span("batcher.cut", seq):
            roots = np.asarray([f.root for f in futures], np.int64)
            b = len(futures)
            if self.supervisor is not None:
                # the supervisor pads internally (it may bisect the wave)
                slots = roots
                n_slots = (bitmap.num_words(b) * bitmap.WORD_BITS
                           if self.supervisor.pad_to_plane else b)
            else:
                slots = roots
                if self.pad_to_plane:
                    slots, b = bitmap.pad_plane_slots(roots)
                n_slots = int(slots.size)
            ws = WaveStats(wave_id=-1, batch=b, n_slots=n_slots,
                           t_start=self.clock(), seconds=0.0, iterations=0,
                           edges_inspected=0, push_iters=0, pull_iters=0,
                           traversed_edges=None, preempted=preempted)
            return _Prepared(futures=futures, slots=slots, b=b, ws=ws,
                             seq=seq)

    def _wave_deadline(self, futures: list[BFSFuture]) -> float | None:
        """Tightest remaining request deadline, for the wave watchdog."""
        dls = [f.t_deadline for f in futures if f.t_deadline is not None]
        if not dls:
            return None
        return max(min(dls) - self.clock(), 1e-3)

    def _execute(self, prep: _Prepared) -> list[_Executed]:
        """Dispatcher stage: the engine call(s), nothing else.

        Engine-idle accounting rides here: the gap between the previous
        wave's engine return and this wave's engine entry is time the
        engine spent waiting on the host.
        """
        with span("batcher.execute", prep.seq):
            return self._execute_wave(prep)

    def _execute_wave(self, prep: _Prepared) -> list[_Executed]:
        t0 = time.perf_counter()
        with self._cond:
            if self._last_exec_end is not None:
                self._idle_seconds += max(t0 - self._last_exec_end, 0.0)
        ws = prep.ws
        ws.t_dispatch = self.clock()
        try:
            if self.supervisor is not None:
                wave = self.supervisor.run_wave(
                    prep.slots, deadline=self._wave_deadline(prep.futures))
                ws.t_engine_done = self.clock()
                out = [_Executed(prep=prep, wave=wave)]
            else:
                # BFSEngine protocol: run_batch + last_stats, no sniffing
                levels = np.asarray(self.engine.run_batch(prep.slots))
                ws.t_engine_done = self.clock()
                ws.seconds = time.perf_counter() - t0
                st = dict(getattr(self.engine, "last_stats", {}))
                ws.iterations = int(st.get("iterations", 0))
                ws.edges_inspected = int(st.get("edges_inspected", 0))
                ws.push_iters = int(st.get("push_iters", 0))
                ws.pull_iters = int(st.get("pull_iters", 0))
                tpp = st.get("traversed_per_plane")
                if tpp is not None:
                    # pad slots sliced off here, no host recount needed
                    ws.traversed_edges = int(
                        np.sum(np.asarray(tpp[: prep.b], np.int64)))
                out = [_Executed(prep=prep, levels=levels)]
        except Exception as exc:       # resolve, don't kill the worker
            if ws.t_engine_done is None:
                ws.t_engine_done = self.clock()
            ws.seconds = time.perf_counter() - t0
            out = [_Executed(prep=prep, exc=exc)]
            if (self.supervisor is None
                    and classify_fault(exc) == DETERMINISTIC
                    and len(prep.futures) > 1):
                # a root rejected at dispatch time (possible when submit
                # had no |V| to validate against) must not fail its
                # co-batched neighbors: isolate each request as its own
                # singleton wave.  CAPPED: the len > 1 guard means a
                # failing singleton fails its future outright — no
                # request is ever retried more than once, and transient
                # faults never take this path (they fail the wave's
                # futures below; wrap the engine in an EngineSupervisor
                # for retry/backoff/bisection policy instead).  The
                # singleton re-runs happen HERE, on the dispatcher
                # thread — they are engine calls.
                out[0].futures_owned_elsewhere = True
                for f in prep.futures:
                    out.extend(self._execute(self._prepare([f])))
        finally:
            with self._cond:
                self._last_exec_end = time.perf_counter()
        return out

    def _finish(self, execs: list[_Executed]) -> WaveStats:
        """Finisher stage: slice rows, resolve futures, book stats."""
        first: WaveStats | None = None
        for ex in execs:
            with span("batcher.finish", ex.prep.seq):
                ws = self._finish_one(ex)
            if first is None:
                first = ws
        return first

    def _health_event(self, failed: bool):
        """One wave's verdict for the health state machine: engine-failure
        waves increment ``consecutive_failures``, healthy waves reset it."""
        with self._cond:
            self.consecutive_failures = (
                self.consecutive_failures + 1 if failed else 0)

    def _offer_failure(self, fut: BFSFuture, exc: BaseException) -> bool:
        """Ask the pool's failure handler to take over a failing future.
        A handler exception must not kill the finisher: treat it as
        'declined' and fail the future normally."""
        if self.failure_handler is None:
            return False
        try:
            return bool(self.failure_handler(fut, exc))
        except Exception:
            return False

    def _finish_one(self, ex: _Executed) -> WaveStats:
        prep, ws = ex.prep, ex.prep.ws
        futures = prep.futures
        if ex.wave is not None:
            return self._finish_supervised(ex)
        if ex.exc is not None:
            self._health_event(True)
            ws.error = f"{type(ex.exc).__name__}: {ex.exc}"
            if ex.futures_owned_elsewhere:
                # the singleton re-dispatches resolve (and account) the
                # futures; this record only books the failed parent wave
                self._record(ws)
                return ws
            kept = [f for f in futures
                    if not self._offer_failure(f, ex.exc)]
            # failed futures still resolved: their submit->fail latency
            # belongs in the percentile base (an SLO-blind p99 that
            # excludes precisely the slow failures is how misses hide).
            # Handed-off futures are NOT resolved here — their eventual
            # worker books them — but they left this worker's in-flight.
            t_res = self.clock()
            lats = [t_res - f.t_submit for f in kept]
            ws.latencies.extend(lats)
            ws.failed = len(kept)
            self._book_slo(ws, kept, t_res, all_failed=True)
            self._record(ws)
            for f, lat in zip(kept, lats):
                f.wave = ws
                f.latency = lat
                f.slo_miss = (None if f.t_deadline is None
                              else True)
                f._fail(ex.exc)
            self._dec_inflight(len(futures))
            return ws
        self._health_event(False)
        levels = bitmap.slice_plane_rows(ex.levels, prep.b)
        if ws.traversed_edges is None and self.out_deg is not None:
            # engines without per-plane counts: recount over the REAL
            # requests only — pad slots are duplicates and must not
            # inflate the wave's TEPS
            ws.traversed_edges = count_traversed_edges(self.out_deg,
                                                       levels)
        # finish the wave record BEFORE waking any waiter: a client whose
        # result() just returned must see this wave in stats()
        t_res = self.clock()
        latencies = [t_res - f.t_submit for f in futures]
        ws.latencies.extend(latencies)
        self._book_slo(ws, futures, t_res)
        self._record(ws)
        for f, lv, lat in zip(futures, levels, latencies):
            f.slo_miss = (None if f.t_deadline is None
                          else t_res > f.t_deadline)
            # copy the row: handing out a view would pin the whole padded
            # [B, |V|] wave matrix for as long as any client keeps it
            f._resolve(np.ascontiguousarray(lv), ws, lat)
        self._dec_inflight(len(futures))
        return ws

    def _finish_supervised(self, ex: _Executed) -> WaveStats:
        """Book a SupervisedWave: run_wave never raises for engine faults —
        it returns one outcome per root (levels or typed error) after the
        watchdog / typed-retry / bisection / degradation policy ran."""
        prep, ws, wave = ex.prep, ex.prep.ws, ex.wave
        futures = prep.futures
        # engine-busy seconds only (excludes retry backoff sleeps), so
        # aggregate TEPS over busy time stays comparable with the
        # unsupervised path
        ws.seconds = wave.seconds
        st = wave.stats
        ws.iterations = int(st.get("iterations", 0))
        ws.edges_inspected = int(st.get("edges_inspected", 0))
        ws.push_iters = int(st.get("push_iters", 0))
        ws.pull_iters = int(st.get("pull_iters", 0))
        ws.traversals = wave.traversals
        ws.retries = wave.retries
        ws.timeouts = wave.timeouts
        ws.quarantined = list(wave.quarantined)
        ws.demotions = list(wave.demotions)
        if wave.n_failed == len(futures):
            first = next(o.error for o in wave.outcomes
                         if o.error is not None)
            ws.error = f"{type(first).__name__}: {first}"
        # quarantine-only failures are poisoned INPUT, not a sick engine
        self._health_event(wave.n_failed > len(wave.quarantined))
        # offer each failing future to the pool before resolving: a
        # handed-off future is redispatched to a surviving worker and
        # books nothing here (the survivor resolves it end-to-end)
        handed = set()
        for f, o in zip(futures, wave.outcomes):
            if not o.ok and self._offer_failure(f, o.error):
                handed.add(id(f))
        ws.failed = wave.n_failed - len(handed)
        ok_rows = [o.levels for o in wave.outcomes if o.ok]
        if self.out_deg is not None and ok_rows:
            ws.traversed_edges = count_traversed_edges(
                self.out_deg, np.stack(ok_rows))
        t_res = self.clock()
        booked = [f for f in futures if id(f) not in handed]
        for f in booked:
            ws.latencies.append(t_res - f.t_submit)
        self._book_slo(ws, booked, t_res,
                       failed={id(futures[i]) for i, o in
                               enumerate(wave.outcomes) if not o.ok})
        self._record(ws)
        for f, o in zip(futures, wave.outcomes):
            if id(f) in handed:
                continue
            if f.t_deadline is not None:
                f.slo_miss = (not o.ok) or t_res > f.t_deadline
            if o.ok:
                f._resolve(o.levels, ws, t_res - f.t_submit)
            else:
                f.wave = ws
                f.latency = t_res - f.t_submit
                f._fail(o.error)
        self._dec_inflight(len(futures))
        return ws

    def _book_slo(self, ws: WaveStats, futures: list[BFSFuture],
                  t_res: float, all_failed: bool = False,
                  failed: set | None = None):
        """Per-wave SLO accounting: a deadline request misses when it
        resolves late OR resolves with an error (a typed failure inside
        the SLO window is still not the answer the client asked for)."""
        for f in futures:
            if f.t_deadline is None:
                continue
            ws.deadline_requests += 1
            if (all_failed or t_res > f.t_deadline
                    or (failed is not None and id(f) in failed)):
                ws.slo_misses += 1

    def _dec_inflight(self, n: int):
        with self._cond:
            self._inflight -= n

    def _record(self, ws: WaveStats):
        with self._cond:
            ws.wave_id = self._n_waves
            self.waves.append(ws)
            self._n_waves += 1
            self._n_failed += ws.failed
            self._n_slo_requests += ws.deadline_requests
            self._n_slo_misses += ws.slo_misses
            # a failed wave burned engine time too: busy seconds accrue
            # for every wave that ran, or lifetime TEPS reads inflated
            # under chaos
            self._busy_seconds += ws.seconds
            self._traversed += ws.traversed_edges or 0
            # injected-clock service estimate drives SLO preemption
            dt = max(self.clock() - ws.t_start, 0.0)
            if self._n_waves == 1 and not self._service_primed:
                self._service_est = dt
            else:
                self._service_est = 0.7 * self._service_est + 0.3 * dt
            if ws.error is not None:
                self._n_errors += 1
            else:
                self._n_requests += ws.batch - ws.failed

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate serving stats: exact totals over the batcher's whole
        lifetime, latency percentiles over the last ``stats_history``
        waves retained in ``self.waves``."""
        with self._cond:               # consistent snapshot vs the worker
            waves = list(self.waves)
            n_waves, n_errors = self._n_waves, self._n_errors
            n_req, busy = self._n_requests, self._busy_seconds
            idle = self._idle_seconds
            traversed = self._traversed
            n_failed = self._n_failed
            n_slo, n_miss = self._n_slo_requests, self._n_slo_misses
            n_shed = self._n_shed
            consec = self.consecutive_failures
        n_ok = n_waves - n_errors
        # EVERY resolved request contributes its latency — including the
        # ones whose wave failed: excluding them made p99 blind to
        # exactly the requests that blew the SLO
        lats = np.asarray([l for w in waves for l in w.latencies],
                          np.float64)
        out = dict(
            waves=n_waves, errors=n_errors, requests=n_req,
            mean_batch=round(n_req / n_ok, 2) if n_ok else 0.0,
            busy_seconds=round(busy, 4),
            engine_idle_seconds=round(idle, 4),
            pipeline=self.pipeline,
        )
        if n_failed:
            out["requests_failed"] = n_failed
        if self.shed or n_shed:
            out["shed"] = n_shed
        if consec:
            out["consecutive_failures"] = consec
        if n_slo:
            out.update(slo_requests=n_slo, slo_misses=n_miss,
                       slo_miss_rate=round(n_miss / n_slo, 4))
        if self.supervisor is not None:
            out["fault_tolerance"] = self.supervisor.stats()
        if self.out_deg is not None:   # without degrees TEPS is unknowable
            out.update(traversed_edges=int(traversed),
                       aggregate_teps=round(traversed / max(busy, 1e-12),
                                            1))
        if lats.size:
            out.update(
                latency_mean=round(float(lats.mean()), 4),
                latency_p50=round(float(np.percentile(lats, 50)), 4),
                latency_p99=round(float(np.percentile(lats, 99)), 4),
                latency_p999=round(float(np.percentile(lats, 99.9)), 4),
            )
        return out


def plane_wave_sizes(max_batch: int) -> list[int]:
    """Every padded wave size a batcher with cap ``max_batch`` can run.

    Partial waves pad to whole plane words (32, 64, ..., up to the padded
    cap); warm these shapes before serving so no wave pays the kernels'
    builds and first launches inside its measured service time.
    """
    padded = bitmap.num_words(max_batch) * bitmap.WORD_BITS
    return list(range(bitmap.WORD_BITS, padded + 1, bitmap.WORD_BITS))


def drive_open_loop(batcher, roots, rate: float | None = None,
                    rng: np.random.Generator | None = None,
                    raise_errors: bool = True,
                    deadline: float | None = None,
                    allow_shed: bool = False) -> list[BFSFuture]:
    """Submit ``roots`` open-loop, drain the batcher, return the futures.

    With ``rate`` (req/s) arrivals follow a Poisson process against an
    ABSOLUTE schedule — sleeping a fresh exponential gap per request would
    add the submit overhead on top of every gap and systematically
    undershoot the requested rate.  ``rate=None`` submits back-to-back.
    ``deadline`` attaches the same relative SLO to every request.
    Raises the wave's error if any request failed; ``raise_errors=False``
    (the chaos arms) only asserts every future RESOLVED — with levels or a
    typed error — so injected faults don't abort the run but a hang still
    surfaces as ``TimeoutError``.  ``allow_shed=True`` (serving with
    admission control on) treats a typed ``Overloaded`` reject as a
    normal open-loop outcome: the request is dropped, the stream keeps
    going, and only ADMITTED requests return futures.
    """
    roots = np.asarray(roots)
    if rate:
        rng = rng or np.random.default_rng(0)
        arrivals = np.cumsum(rng.exponential(1.0 / rate, roots.size))
    else:
        arrivals = np.zeros(roots.size)
    t0 = time.monotonic()
    futures = []
    for r, t_arr in zip(roots, arrivals):
        delay = t_arr - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        try:
            futures.append(batcher.submit(int(r), deadline=deadline))
        except Overloaded:
            if not allow_shed:
                raise
    batcher.close(drain=True)
    for f in futures:
        if raise_errors:
            f.result(timeout=0)    # drained => resolved; surface errors
        elif not f.done():         # resolution (either way) is mandatory
            raise TimeoutError(
                f"request for root {f.root} never resolved after drain")
    return futures
