"""The one general traffic generator: it reads a mix file
(``bfsbench/traffic/<mix>.json``) and drives, in a closed or an open
loop, the program's entry that the mix names.

A mix file holds data only:

* ``entry``: the loop module ``bfsbench/loops/<entry>.py`` that wraps one
  public entry of the program (``run_batch``: ``MultiSourceBFSRunner``
  waves; ``bfs_runner``: ``BFSRunner.run``, one root at a time;
  ``batcher``: a ``DynamicBatcher`` in front of a
  ``MultiSourceBFSRunner``).  A new entry is a new module there: its
  ``make(g, mix, keys, rng, tracer, entry=None)`` returns a loop of this
  file (``ClosedLoop``, ``OpenLoop`` or one built on them);
* ``batch``: roots a call, in a closed loop;
* ``rate`` (requests a second), or ``phases`` (a list of ``{"rate",
  "seconds"}`` repeated over the window: bursts on and off), for an open
  loop;
* ``runner``, ``batcher``: keyword arguments of the program's objects.

Roots are Graph500 search keys, vertices of degree >= 1, drawn from the
seed: distinct within a wave in a closed loop, uniform with replacement
in the open loop.  The open loop's gaps in each phase are the same
multiset for every seed (drawn once from a fixed stream and shuffled by
the seed), so every seed offers the same number of requests in the
window, in another order.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# Open-loop gaps come from this fixed stream, whatever the seed.
_GAP_STREAM = 20260101
# A request is waited for this long past the window's close.
_LATE_S = 60.0
# Answers kept for the comparison with the reference, at most.
SAMPLE = 48
_WORD_BITS = 32


@dataclasses.dataclass
class Unit:
    """One call into a closed-loop entry."""

    t0: float
    t1: float
    roots: np.ndarray
    ok: bool
    program_s: float | None = None   # the program's time to its last level
    count_s: float = 0.0             # the benchmark's byte counting inside


@dataclasses.dataclass
class Request:
    """One open-loop request, on the clock of ``time.monotonic``."""

    root: int
    due: float
    done: float | None = None
    ok: bool = False
    wave_start: float | None = None  # the carrying wave's cut (program)
    wave_id: int | None = None
    dispatch: float | None = None    # the carrying wave's engine entry


class Reservoir:
    """A uniform sample of at most ``k`` answers, drawn by ``rng``
    (Algorithm R); ``make`` is called only for an answer that is kept."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = make()


def draw_distinct(candidates: np.ndarray, k: int,
                  rng: np.random.Generator) -> np.ndarray:
    """``k`` distinct entries of ``candidates``, drawn by ``rng``."""
    picked: list = []
    seen: set = set()
    while len(picked) < k:
        for i in rng.integers(0, candidates.size, size=k - len(picked)):
            if int(i) not in seen:
                seen.add(int(i))
                picked.append(int(i))
    return candidates[np.asarray(picked, dtype=np.int64)]


def open_loop_schedule(rate: float, seconds: float,
                       rng: np.random.Generator,
                       fixed: np.random.Generator | None = None
                       ) -> np.ndarray:
    """Arrival offsets (seconds from the window's start) of a Poisson
    stream at ``rate``: the gaps drawn from a fixed stream until they fill
    ``seconds``, shuffled by ``rng``."""
    if fixed is None:
        fixed = np.random.default_rng(_GAP_STREAM)
    gaps: list = []
    total = 0.0
    while True:
        gap = float(fixed.exponential(1.0 / rate))
        if total + gap > seconds:
            break
        total += gap
        gaps.append(gap)
    return np.cumsum(rng.permutation(np.asarray(gaps, dtype=np.float64)))


def arrivals(mix: dict, seconds: float,
             rng: np.random.Generator) -> np.ndarray:
    """The mix's arrival offsets over ``seconds``: one Poisson stream at
    ``rate``, or its ``phases`` (``{"rate", "seconds"}`` each) in turn,
    repeated until the window is full, each phase's stretch drawn as
    ``open_loop_schedule`` draws a window."""
    phases = mix.get("phases") or [{"rate": mix["rate"], "seconds": seconds}]
    fixed = np.random.default_rng(_GAP_STREAM)
    parts: list = []
    t, i = 0.0, 0
    while t < seconds:
        ph = phases[i % len(phases)]
        span = min(float(ph["seconds"]), seconds - t)
        if float(ph["rate"]) > 0:
            parts.append(t + open_loop_schedule(float(ph["rate"]), span,
                                                rng, fixed))
        t, i = t + span, i + 1
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=np.float64))


def wave_sizes(max_batch: int) -> list[int]:
    """Every padded size a batcher of ``max_batch`` can run: whole plane
    words of 32 slots."""
    words = -(-max_batch // _WORD_BITS)
    return [_WORD_BITS * w for w in range(1, words + 1)]


class ClosedLoop:
    """One client calling ``entry(roots) -> (rows, program seconds)`` back
    to back, ``batch`` roots a call."""

    open_loop = False
    outer_label = "benchmark"

    def __init__(self, entry, batch: int, keys: np.ndarray,
                 rng: np.random.Generator, tracer):
        self.entry, self.batch, self.keys = entry, batch, keys
        self.rng, self.tracer = rng, tracer
        self.counter = None          # the traced run's Probe

    def _roots(self) -> np.ndarray:
        return draw_distinct(self.keys, self.batch, self.rng)

    def warm(self) -> None:
        self.entry(self._roots())

    def window(self, seconds: float, sample: Reservoir) -> list[Unit]:
        units: list = []
        t_start = time.perf_counter()
        with self.tracer.span("window"):
            while True:
                roots = self._roots()
                c0 = self.counter.count_s if self.counter else 0.0
                t0 = time.perf_counter()
                try:
                    with self.tracer.span("entry"):
                        rows, program_s = self.entry(roots)
                    ok = True
                except Exception as exc:      # an answer that never comes
                    print(f"entry failed: {type(exc).__name__}: {exc}",
                          file=sys.stderr)
                    rows, program_s, ok = None, None, False
                t1 = time.perf_counter()
                count_s = (self.counter.count_s - c0) if self.counter else 0.0
                units.append(Unit(t0, t1, roots, ok, program_s, count_s))
                if ok:
                    slot = int(self.rng.integers(0, len(roots)))
                    sample.offer(lambda: (int(roots[slot]),
                                          np.array(rows[slot])))
                if t1 - t_start >= seconds:
                    break
        return units

    def close(self) -> None:
        self.entry = None


class OpenLoop:
    """Single-root requests on the mix's arrival schedule into a server
    that ``make_server(engine)`` builds (the program's ``DynamicBatcher``);
    a collector thread takes each answer, in order, as it reaches the
    host.  The engine's ``run_batch`` is wrapped for the window, to stamp
    each wave's entry into the engine."""

    open_loop = True
    outer_label = "batcher"

    def __init__(self, engine, make_server, mix: dict, keys: np.ndarray,
                 rng: np.random.Generator, tracer, max_batch: int):
        self.engine, self.make_server = engine, make_server
        self.mix, self.keys, self.rng, self.tracer = mix, keys, rng, tracer
        self.max_batch = max_batch
        self.batcher = None
        self.counter = None

    def warm(self) -> None:
        for size in wave_sizes(self.max_batch):
            self.engine.run_batch(draw_distinct(self.keys, size, self.rng))

    def window(self, seconds: float, sample: Reservoir) -> list[Request]:
        calls: list = []          # (engine entry, slots) of each wave
        run_batch = self.engine.run_batch
        own = "run_batch" in vars(self.engine)
        tracer = self.tracer

        def stamped(roots, **kw):
            calls.append((time.monotonic(), np.asarray(roots)))
            with tracer.span("entry"):
                return run_batch(roots, **kw)
        self.engine.run_batch = stamped
        offsets = arrivals(self.mix, seconds, self.rng)
        roots = self.keys[self.rng.integers(0, self.keys.size,
                                            size=offsets.size)]
        self.batcher = self.make_server(self.engine)
        todo: queue.Queue = queue.Queue()
        reqs = [Request(int(r), 0.0) for r in roots]
        with self.tracer.span("window"):
            t0 = time.monotonic()
            for req, off in zip(reqs, offsets):
                req.due = t0 + float(off)
            collector = threading.Thread(
                target=self._collect, args=(todo, t0 + seconds + _LATE_S,
                                            sample), daemon=True)
            collector.start()
            for req in reqs:
                delay = req.due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                try:
                    todo.put((req, self.batcher.submit(req.root)))
                except Exception as exc:      # refused: counts as missing
                    print(f"submit failed: {type(exc).__name__}: {exc}",
                          file=sys.stderr)
                    req.done = time.monotonic()
            todo.put(None)
            collector.join(timeout=seconds + 2 * _LATE_S)
        self.batcher.close(drain=True, timeout=_LATE_S)
        if own:
            self.engine.run_batch = run_batch
        else:
            del self.engine.run_batch
        stamp_dispatch(reqs, calls)
        return reqs

    @staticmethod
    def _collect(todo: queue.Queue, give_up: float,
                 sample: Reservoir) -> None:
        while (item := todo.get()) is not None:
            req, fut = item
            exc = fut.exception(timeout=max(give_up - time.monotonic(), 0.0))
            req.done = time.monotonic()
            if not fut.done() or exc is not None:
                if exc is not None:
                    print(f"request failed: {type(exc).__name__}: {exc}",
                          file=sys.stderr)
                continue
            req.ok = True
            if fut.wave is not None:
                req.wave_start = fut.wave.t_start
                req.wave_id = fut.wave.wave_id
            row = fut.result(timeout=0)
            sample.offer(lambda: (req.root, np.array(row)))
            del fut, row

    def stats(self) -> dict | None:
        return None if self.batcher is None else self.batcher.stats()

    def close(self) -> None:
        self.batcher = None
        self.engine = None


def stamp_dispatch(reqs: list[Request], calls: list) -> None:
    """Give each served request its wave's engine entry: the batcher's
    waves enter the engine in the order their ids are given (one
    dispatcher, first in first out), so wave ``i`` is the ``i``-th call;
    a call whose slots do not hold the request's root is not its wave,
    and the request keeps no stamp."""
    for req in reqs:
        i = req.wave_id
        if req.ok and i is not None and 0 <= i < len(calls):
            t, slots = calls[i]
            if np.any(slots == req.root):
                req.dispatch = t


def load_loop(name: str, here: Path = HERE):
    """The loop module ``loops/<name>.py`` under ``here``."""
    path = here / "loops" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no loop {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        "bfsbench_loop_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_loop(g, mix: dict, keys: np.ndarray, rng: np.random.Generator,
              tracer, entry=None, here: Path = HERE):
    """The loop of the mix's ``entry`` around the program's graph ``g``
    (or around ``entry``, a stand-in with the same calls, for the
    control)."""
    return load_loop(mix["entry"], here).make(g, mix, keys, rng, tracer,
                                              entry=entry)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
