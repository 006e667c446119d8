"""Worker pool: several MS-BFS engines behind ONE submit surface (PyTorch
port of ``repro.launch.pool``).

One ``DynamicBatcher`` keeps one engine busy; a pool keeps several —
the serving analogue of ScalaBFS running 64 processing elements against
32 HBM pseudo-channels, where aggregate throughput comes from many
independent workers, not one wider one.  ``WorkerPool`` owns one
:class:`~repro_torch.launch.dynbatch.DynamicBatcher` per engine (each with its
own bounded queue, worker thread, and optionally its own
``EngineSupervisor``) and routes every ``submit`` to the least-loaded
worker:

* Routing is JOIN-SHORTEST-QUEUE on ``DynamicBatcher.backlog()``
  (queued + cut-but-unfinished requests), with a round-robin tiebreak so
  an idle pool still spreads waves across engines instead of pinning
  everything to worker 0.
* SLO semantics (``deadline=`` / ``priority=``) pass straight through —
  each worker cuts its own waves urgency-first, and ``stats()`` merges
  the per-worker SLO accounting into one pool-wide miss rate.
* Backpressure composes: a non-blocking submit that finds EVERY worker's
  queue full raises ``QueueFull``; a blocking submit waits on the least
  backlogged worker.
* HEALTH STATE MACHINE: each worker is HEALTHY, SUSPECT, or EVICTED.
  Consecutive engine-failure waves (quarantine-only waves don't count)
  drive HEALTHY -> SUSPECT (ranked last for new work) at
  ``suspect_after`` and SUSPECT -> EVICTED at ``evict_after``; eviction
  drains the worker's queue and REDISPATCHES every queued and failing
  in-flight future to survivors (respecting their ``max_pending``), so
  a permanently dead engine costs its requests a detour, not an error.
  A successful wave resets the streak and re-admits a SUSPECT worker.
  :meth:`probe_evicted` (manual, or periodic via ``probe_interval``)
  re-runs a probe traversal on each evicted engine and rebuilds a fresh
  worker around it when it answers again.
* ADMISSION CONTROL (``shed=True``): a deadline request is refused with
  a typed ``Overloaded`` when even the least-delayed admissible worker's
  estimated queue delay (EWMA wave service x waves of backlog) already
  exceeds the SLO — the reject lands in well under one wave time,
  protecting the latency of everything already queued.
* Engines must be INDEPENDENT (their own runner instances — device graph
  tensors may be shared, traversal state is per-runner).  Threads over
  local ``MultiSourceBFSRunner`` instances; on one card their kernels
  share the device (and its default stream), so workers overlap host work
  with each other's device work rather than adding device throughput.

Fake-clock testing works like the single batcher: construct with
``clock=`` (workers then run no threads) and drive with :meth:`pump` /
:meth:`flush` (flush loops until redispatches quiesce); call
:meth:`probe_evicted` yourself in lieu of the probe thread.
"""
from __future__ import annotations

import functools
import threading

import numpy as np

from repro_torch.ft.supervisor import (DETERMINISTIC, RequestQuarantined,
                                       classify_fault)
from repro_torch.launch.dynbatch import (BatcherClosed, BFSFuture,
                                         DynamicBatcher, Overloaded,
                                         QueueFull, WaveStats)

HEALTHY, SUSPECT, EVICTED = "healthy", "suspect", "evicted"
HEALTH_STATES = (HEALTHY, SUSPECT, EVICTED)


def _redispatchable(exc: BaseException) -> bool:
    """Should a future failing with ``exc`` be retried on ANOTHER worker?

    Deterministic (input-shaped) faults and quarantined roots would fail
    identically everywhere — redispatching them just poisons a healthy
    worker's streak.  Transient faults (timeouts, kernel faults,
    integrity violations, generic runtime errors) are the worker's
    problem, not the request's: those travel.
    """
    if isinstance(exc, (RequestQuarantined, BatcherClosed, Overloaded)):
        return False
    return classify_fault(exc) != DETERMINISTIC


class WorkerPool:
    """Route single-root BFS queries across a pool of per-engine batchers.

    ``engines``: independent engine instances (one worker each).  Every
    other keyword is forwarded to each worker's ``DynamicBatcher`` —
    ``window``, ``max_batch``, ``pipeline``, ``slo_margin``, ``clock``,
    etc., so the pool's workers are homogeneous by construction.

    ``evict_after`` / ``suspect_after``: consecutive engine-failure waves
    before a worker is evicted / marked suspect (suspect defaults to half
    the evict threshold, at least 1).  ``shed=True`` turns on pool-level
    admission control.  ``probe_interval`` (seconds, real time) starts a
    daemon probe thread that periodically tries to re-admit evicted
    workers; ``engine_factory(idx) -> engine`` (optional) builds a
    REPLACEMENT engine at re-admission instead of reusing the old object.
    """

    def __init__(self, engines, *, out_deg: np.ndarray | None = None,
                 evict_after: int = 3, suspect_after: int | None = None,
                 shed: bool = False, probe_interval: float | None = None,
                 engine_factory=None, **batcher_kw):
        engines = list(engines)
        if not engines:
            raise ValueError("WorkerPool needs at least one engine")
        if evict_after < 1:
            raise ValueError(f"need evict_after >= 1, got {evict_after}")
        self.evict_after = int(evict_after)
        self.suspect_after = (max(1, self.evict_after // 2)
                              if suspect_after is None
                              else int(suspect_after))
        if not (1 <= self.suspect_after <= self.evict_after):
            raise ValueError(
                f"need 1 <= suspect_after <= evict_after, got "
                f"{self.suspect_after} vs {self.evict_after}")
        self.shed = bool(shed)
        self.engine_factory = engine_factory
        self._engines = engines
        self._batcher_kw = dict(batcher_kw, out_deg=out_deg)
        self.workers: list[DynamicBatcher] = [
            DynamicBatcher(
                e, failure_handler=functools.partial(
                    self._on_request_failure, i),
                **self._batcher_kw)
            for i, e in enumerate(engines)]
        self._health: list[str] = [HEALTHY] * len(engines)
        self._retired: list[DynamicBatcher] = []   # abandoned after probe
        self._rr = 0                      # round-robin tiebreak cursor
        self._lock = threading.RLock()    # health transitions + counters
        self._closed = False
        self._n_evictions = 0
        self._n_redispatches = 0
        self._n_shed = 0                  # pool-level admission rejects
        self._n_probes = 0
        self._n_probe_failures = 0
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        if probe_interval is not None:
            if probe_interval <= 0:
                raise ValueError(
                    f"need probe_interval > 0, got {probe_interval}")
            self._probe_thread = threading.Thread(
                target=self._probe_loop, args=(float(probe_interval),),
                name="pool-probe", daemon=True)
            self._probe_thread.start()

    # -- health state machine ---------------------------------------------

    def health(self) -> list[str]:
        """Per-worker health snapshot (``HEALTH_STATES`` values)."""
        with self._lock:
            self._refresh_health_locked()
            return list(self._health)

    def _refresh_health_locked(self):
        # SUSPECT -> HEALTHY re-admission: a successful wave reset the
        # worker's failure streak (eviction never auto-reverses — only
        # probe_evicted readmits)
        for i, h in enumerate(self._health):
            if h == SUSPECT and self.workers[i].consecutive_failures == 0:
                self._health[i] = HEALTHY

    def _on_request_failure(self, idx: int, fut: BFSFuture,
                            exc: BaseException) -> bool:
        """Worker ``idx``'s failure handler (runs on its finisher thread).

        Notes the failure against the health state machine, evicts at the
        threshold (draining the queue to survivors), and decides whether
        THIS future travels: True hands ownership to the pool (the
        future was requeued on a survivor), False lets the worker fail it
        normally.
        """
        evict = False
        with self._lock:
            if not self._closed and self._health[idx] != EVICTED:
                streak = self.workers[idx].consecutive_failures
                if streak >= self.evict_after:
                    self._health[idx] = EVICTED
                    self._n_evictions += 1
                    evict = True
                elif streak >= self.suspect_after:
                    self._health[idx] = SUSPECT
        if evict:
            self._drain_evicted(idx)
        if self._closed or not _redispatchable(exc):
            return False
        return self._redispatch(fut, exclude=idx)

    def _drain_evicted(self, idx: int):
        """Move an evicted worker's queued futures to survivors; anything
        that cannot be placed fails typed rather than hanging."""
        for f in self.workers[idx].cancel_pending():
            if not self._redispatch(f, exclude=idx):
                f._fail(Overloaded(
                    f"worker {idx} evicted and no surviving worker "
                    f"could absorb root {f.root}"))

    def _redispatch(self, fut: BFSFuture, exclude: int | None = None
                    ) -> bool:
        """Requeue a future on the best admissible worker.  Bounded: a
        future hops at most workers-1 times, so a pool-wide outage fails
        requests instead of circulating them forever."""
        hops = getattr(fut, "_redispatches", 0)
        if hops >= max(len(self.workers) - 1, 1):
            return False
        for i in self._ranked():
            if i == exclude:
                continue
            try:
                self.workers[i]._submit_future(fut)
            except (QueueFull, BatcherClosed):
                continue
            fut._redispatches = hops + 1
            with self._lock:
                self._n_redispatches += 1
            return True
        return False

    def _probe_loop(self, interval: float):
        while not self._probe_stop.wait(interval):
            if self._closed:
                return
            try:
                self.probe_evicted()
            except Exception:
                pass               # probe must never kill its own thread

    def _probe_engine(self, eng) -> bool:
        """One probe traversal from root 0: does the engine answer?"""
        try:
            if hasattr(eng, "run_wave"):   # EngineSupervisor facade
                wave = eng.run_wave(np.asarray([0], np.int64))
                return wave.n_failed == 0
            eng.run_batch(np.asarray([0], np.int64))
            return True
        except Exception:
            return False

    def probe_evicted(self) -> int:
        """Try to re-admit every EVICTED worker; returns how many came
        back.  Each probe runs one traversal on the (possibly rebuilt)
        engine OUTSIDE the serving path; success swaps in a fresh
        ``DynamicBatcher`` — the old one is abandoned unjoined, because a
        wedged engine call would hang any attempt to join its threads.
        """
        with self._lock:
            targets = [i for i, h in enumerate(self._health)
                       if h == EVICTED]
        readmitted = 0
        for idx in targets:
            if self._closed:
                break
            with self._lock:
                self._n_probes += 1
            eng = self._engines[idx]
            if self.engine_factory is not None:
                try:
                    eng = self.engine_factory(idx)
                except Exception:
                    with self._lock:
                        self._n_probe_failures += 1
                    continue
            if not self._probe_engine(eng):
                with self._lock:
                    self._n_probe_failures += 1
                continue
            old = self.workers[idx]
            for f in old.cancel_pending():   # raced in before eviction
                if not self._redispatch(f, exclude=idx):
                    f._fail(Overloaded(
                        f"worker {idx} rebuilt and no other worker "
                        f"could absorb root {f.root}"))
            with old._cond:
                old._closed = True
                old._cond.notify_all()
            self._retired.append(old)
            self._engines[idx] = eng
            fresh = DynamicBatcher(
                eng, failure_handler=functools.partial(
                    self._on_request_failure, idx),
                **self._batcher_kw)
            with self._lock:
                self.workers[idx] = fresh
                self._health[idx] = HEALTHY
            readmitted += 1
        return readmitted

    # -- client side ------------------------------------------------------

    def _ranked(self) -> list[int]:
        """Admissible worker indices by (suspect-last, backlog,
        round-robin distance) ascending.  EVICTED and closed workers are
        excluded — nothing new is ever routed to them."""
        n = len(self.workers)
        with self._lock:
            self._refresh_health_locked()
            elig = [i for i in range(n)
                    if self._health[i] != EVICTED
                    and not self.workers[i]._closed]
            suspect = {i for i in elig if self._health[i] == SUSPECT}
        if not elig:
            return []
        loads = {i: self.workers[i].backlog() for i in elig}
        order = sorted(elig, key=lambda i: (i in suspect, loads[i],
                                            (i - self._rr) % n))
        self._rr = (order[0] + 1) % n
        return order

    def submit(self, root: int, *, block: bool = True,
               timeout: float | None = None, deadline: float | None = None,
               priority: int = 0) -> BFSFuture:
        """Enqueue one query on the least-backlogged admissible worker.

        Non-blocking submits fail over: if the chosen worker's queue is
        full the next-least-loaded one is tried, and ``QueueFull`` only
        propagates when EVERY worker is at capacity.  Blocking submits
        wait on the least-loaded worker (its thread is draining it).

        Raises ``Overloaded`` when every worker is evicted (after one
        inline re-admission probe), or — with ``shed=True`` and a
        ``deadline`` — when even the best worker's estimated queue delay
        already exceeds the deadline.
        """
        order = self._ranked()
        if not order:
            # all evicted: one inline probe is the last resort before
            # refusing (the background probe may simply not have run yet)
            self.probe_evicted()
            order = self._ranked()
            if not order:
                raise Overloaded(
                    f"all {len(self.workers)} workers evicted")
        if self.shed and deadline is not None:
            est = min(self.workers[i].estimated_delay() for i in order)
            if est > deadline:
                with self._lock:
                    self._n_shed += 1
                raise Overloaded(
                    f"estimated queue delay {est:.4f}s on the best of "
                    f"{len(order)} workers exceeds the request deadline "
                    f"{deadline:.4f}s")
        if block:
            return self.workers[order[0]].submit(
                root, block=True, timeout=timeout, deadline=deadline,
                priority=priority)
        last: QueueFull | None = None
        for i in order:
            try:
                return self.workers[i].submit(
                    root, block=False, deadline=deadline,
                    priority=priority)
            except QueueFull as exc:
                last = exc
        raise QueueFull(
            f"all {len(order)} admissible worker queues full") from last

    def backlog(self) -> int:
        return sum(w.backlog() for w in self.workers)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler (fake-clock mode) --------------------------------------

    def pump(self, force: bool = False) -> list[WaveStats]:
        """Dispatch at most one due wave PER WORKER (fake-clock mode)."""
        out = []
        for w in list(self.workers):
            ws = w.pump(force)
            if ws is not None:
                out.append(ws)
        return out

    def flush(self) -> list[WaveStats]:
        """Dispatch everything pending on every worker, deadlines
        ignored.  Loops until the pool quiesces: an eviction mid-flush
        redispatches futures onto workers already flushed this pass, so
        one sweep is not enough."""
        out: list[WaveStats] = []
        while True:
            waves = [ws for w in list(self.workers) for ws in w.flush()]
            if not waves:
                return out
            out.extend(waves)

    def close(self, drain: bool = True, timeout: float | None = None):
        """Close every worker (serially; each drains its own queue).

        The pool is marked closed FIRST so in-flight failure handlers
        stop redispatching — a future must never be requeued onto a
        worker that is about to close underneath it (it would hang or die
        with a confusing ``BatcherClosed`` instead of its real error).
        Evicted workers are closed without drain: their queues were
        already moved to survivors at eviction, and asking a dead engine
        to serve a farewell wave helps nobody.
        """
        with self._lock:
            self._closed = True
            health = list(self._health)
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout)
            self._probe_thread = None
        for i, w in enumerate(self.workers):
            w.close(drain=drain and health[i] != EVICTED, timeout=timeout)

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        """Pool-wide aggregate: exact totals summed across workers,
        latency percentiles over the POOLED per-wave latencies (so one
        slow worker shows up in the pool's p99, not just its own), plus
        each worker's own stats under ``per_worker`` and the health /
        eviction / shedding counters of the resilience layer.
        """
        per = [w.stats() for w in self.workers]
        lats: list[float] = []
        for w in self.workers:
            with w._cond:
                lats.extend(l for wave in w.waves for l in wave.latencies)
        with self._lock:
            self._refresh_health_locked()
            health = list(self._health)
            n_evict, n_redisp = self._n_evictions, self._n_redispatches
            n_shed = self._n_shed
            n_probe, n_probe_fail = self._n_probes, self._n_probe_failures
        out = dict(
            workers=len(self.workers),
            waves=sum(p["waves"] for p in per),
            errors=sum(p["errors"] for p in per),
            requests=sum(p["requests"] for p in per),
            busy_seconds=round(sum(p["busy_seconds"] for p in per), 4),
            engine_idle_seconds=round(
                sum(p["engine_idle_seconds"] for p in per), 4),
            pipeline=any(p["pipeline"] for p in per),
            health=health,
        )
        if n_evict or n_redisp:
            out.update(evictions=n_evict, redispatches=n_redisp)
        n_shed += sum(p.get("shed", 0) for p in per)
        if self.shed or n_shed:
            out["shed"] = n_shed
        if n_probe:
            out.update(probes=n_probe, probe_failures=n_probe_fail)
        n_failed = sum(p.get("requests_failed", 0) for p in per)
        if n_failed:
            out["requests_failed"] = n_failed
        n_slo = sum(p.get("slo_requests", 0) for p in per)
        if n_slo:
            n_miss = sum(p.get("slo_misses", 0) for p in per)
            out.update(slo_requests=n_slo, slo_misses=n_miss,
                       slo_miss_rate=round(n_miss / n_slo, 4))
        if any("traversed_edges" in p for p in per):
            trav = sum(p.get("traversed_edges", 0) for p in per)
            busy = sum(p["busy_seconds"] for p in per)
            # engine-busy TEPS: edges per second of ENGINE time summed
            # across workers — wall-clock delivered throughput is the
            # harness's job (it knows the stream's makespan, we don't)
            out.update(traversed_edges=int(trav),
                       aggregate_teps=round(trav / max(busy, 1e-12), 1))
        if lats:
            a = np.asarray(lats, np.float64)
            out.update(
                latency_mean=round(float(a.mean()), 4),
                latency_p50=round(float(np.percentile(a, 50)), 4),
                latency_p99=round(float(np.percentile(a, 99)), 4),
                latency_p999=round(float(np.percentile(a, 99.9)), 4),
            )
        if any("fault_tolerance" in p for p in per):
            out["fault_tolerance"] = [p.get("fault_tolerance")
                                      for p in per]
        out["per_worker"] = per
        return out
