"""The program's own spans in the traced run: the ``repro_torch.*`` host
ranges the port opens at its phase boundaries (``src/repro_torch/
trace.py``) and the host's blocking CUDA runtime calls, read from the same
profiler as ``trace.py``'s events and on its clock.

``install()`` extends the traced run, and nothing else:

* the profiler records every thread (``profile_all_threads``, where the
  build takes it), so the batcher's cutter, dispatcher and finisher keep
  their spans;
* ``trace.read_profile`` returns a ``ProgramTrace``: the ``Trace`` the
  benchmark read, with every field as before, plus the program's spans,
  the sync calls, the benchmark's spans with their threads, and the thread
  that launched each device operation (by the events' correlation ids);
* the ``Trace``'s own spans stay those of the thread that opened the
  window, the only thread the profiler recorded before: a counting pause
  on another thread (the probe's K1 hook on the batcher's dispatcher) is
  not cut out of the window or the busy time, so ``idle_share`` and every
  other existing metric read as before;
* on a build whose events lack ``activity_type`` the device's mirror of a
  program span would read as a kernel: it is dropped from ``kernels``, as
  the mirror of a benchmark span is, so every existing metric reads what
  it reads without the program's spans;
* ``ProgramTrace.idle_by_label`` puts a gap under the innermost span open
  at its middle, the program's or the benchmark's, on the thread that
  launched the device operation that ends the gap where the trace links
  it (any thread otherwise); a gap under no span there keeps the label
  the benchmark gave it.

Every traced cell has to list a metric that calls ``install()``: without
it the card's 2.11 build reads the device's mirror of each program span
as a kernel (a test holds every cell of ``BENCHMARK.json`` to this).

The metrics that read the program's spans call ``install()`` when the
harness loads them, before the window is traced.  Untraced runs load no
per-layer metric and are not touched.
"""
from __future__ import annotations

import bisect
import dataclasses
import operator

import torch

from bfsbench import trace

PROGRAM = "repro_torch."
# Runtime calls that block the host until the device has caught up: a
# pageable ``.cpu()`` and a ``torch.tensor(..., device=cuda)`` both end in
# cudaStreamSynchronize.
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
_BASE_READ = trace.read_profile
_BASE_START = trace.Tracer.start
# The label of a gap inside a counting pause on a thread whose pauses are
# not cut (the benchmark's own work).
COUNTING = trace.PREFIX + trace.COUNT


@dataclasses.dataclass
class ProgramTrace(trace.Trace):
    """A ``Trace`` and what the program recorded beside it: ``program``
    (name without the prefix, start, end, thread), ``syncs`` (call, start,
    end, thread), ``threaded`` (the benchmark's spans with their thread)
    and ``launched`` (device operation's start, launching thread or None),
    sorted by start."""

    program: list = dataclasses.field(default_factory=list)
    syncs: list = dataclasses.field(default_factory=list)
    threaded: list = dataclasses.field(default_factory=list)
    launched: list = dataclasses.field(default_factory=list)

    # -- the program's spans in the window --------------------------------
    def named(self, name: str) -> list:
        """(start, end, thread) of the program's ``name`` spans that start
        inside the window."""
        win = self.window()
        if win is None:
            return []
        return [(s, e, t) for n, s, e, t in self.program
                if n == name and win[0] <= s < win[1]]

    def inside(self, outer: list, events: list) -> list:
        """For each (start, end, thread) of ``outer``, the (name, start,
        end) of ``events`` (name, start, end, thread) that start inside it
        on its thread."""
        starts = [s for _, s, _, _ in events]
        out = []
        for s, e, t in outer:
            i = bisect.bisect_left(starts, s)
            got = []
            while i < len(events) and events[i][1] < e:
                n, es, ee, et = events[i]
                if t is None or et is None or et == t:
                    got.append((n, es, ee))
                i += 1
            out.append(got)
        return out

    def pauses(self) -> list:
        """Merged counting pauses of every thread inside the window: the
        benchmark's own work, the cut and any other thread's."""
        win = self.window()
        if win is None:
            return []
        return trace.merge([(max(s, win[0]), min(e, win[1]))
                            for n, s, e, _ in self.threaded
                            if n == trace.COUNT] + self.cut())

    def level_syncs(self) -> list:
        """Blocking runtime calls that start inside each ``level`` span,
        less the benchmark's own: those inside a counting pause and the
        device synchronisation the probe makes just before one."""
        starts = [s for _, s, _, _ in self.syncs]
        probe = set()
        for n, s, _, t in self.threaded:
            if n != trace.COUNT:
                continue
            i = bisect.bisect_left(starts, s) - 1
            while i >= 0 and not (self.syncs[i][2] <= s and (
                    t is None or self.syncs[i][3] in (t, None))):
                i -= 1
            if i >= 0 and self.syncs[i][0] == "cudaDeviceSynchronize":
                probe.add(i)
        paused = self.pauses()
        paused_starts = [ps for ps, _ in paused]
        kept = [ev for i, ev in enumerate(self.syncs)
                if i not in probe and not _within(ev[1], paused,
                                                  paused_starts)]
        return self.inside(self.named("level"), kept)

    # -- idle gaps ---------------------------------------------------------
    def idle_by_label(self, limit: int = 10) -> list:
        """As ``Trace.idle_by_label``, but each gap goes to the innermost
        span open at its middle on the thread that launched the operation
        ending it (on any thread where that is not known): a program span
        as ``repro_torch.<name>``, a benchmark span by its label, a
        counting pause as ``bfsbench.count``; with none open there, the
        gap keeps the benchmark's label."""
        if not self.program and not self.threaded:
            return super().idle_by_label(limit)
        gaps = self.gaps()
        mids = [(gs + ge) // 2 for gs, ge in gaps]
        base = innermost_labels(self, mids)
        owner = self.gap_threads(gaps)
        spans = [(s, e, PROGRAM + n, t) for n, s, e, t in self.program] + [
            (s, e, _label(n), t) for n, s, e, t in self.threaded
            if n != trace.WINDOW]
        by_thread: dict = {}
        for i, t in enumerate(owner):
            by_thread.setdefault(t, []).append(i)
        tot: dict = {}
        for t, idx in by_thread.items():
            pool = sorted((s, e, n) for s, e, n, st in spans
                          if t is None or st == t)
            names = trace.innermost(pool, [mids[i] for i in idx])
            for i, name in zip(idx, names):
                label = name or base[i]
                gs, ge = gaps[i]
                tot[label] = tot.get(label, 0) + (ge - gs)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:limit]
        return [[label, ns / 1e9] for label, ns in top]

    def gap_threads(self, gaps: list) -> list:
        """The thread that launched the device operation starting where
        each gap ends, or None where the trace does not say."""
        starts = [s for s, _ in self.launched]
        known = {t for *_, t in self.program + self.threaded}
        out = []
        for _, ge in gaps:
            i = bisect.bisect_left(starts, ge)
            t = (self.launched[i][1]
                 if i < len(starts) and starts[i] == ge else None)
            out.append(t if t in known else None)
        return out


def _within(t: int, merged: list, starts: list) -> bool:
    """Whether ``t`` lies in one of the sorted disjoint ``merged``."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < merged[i][1]


def _label(name: str) -> str:
    """A benchmark span's gap label."""
    if name == trace.COUNT:
        return COUNTING
    return trace.SPAN_LABELS.get(name, name)


def innermost_labels(tr: trace.Trace, points: list) -> list:
    """The benchmark's label at each point, as ``Trace.idle_by_label``
    gives it."""
    spans = sorted((s, e, n) for n, s, e in tr.spans
                   if n not in (trace.WINDOW, trace.COUNT))
    return [_label(n) if n else tr.outer_label
            for n in trace.innermost(spans, points)]


# -- reading ------------------------------------------------------------------

def _thread(e):
    return e.start_thread_id() if hasattr(e, "start_thread_id") else None


def _correlation(e):
    return e.correlation_id() if hasattr(e, "correlation_id") else None


def _on_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def read_program(events, base: trace.Trace) -> ProgramTrace:
    """``base`` and the program's events of the same profile."""
    program, syncs, threaded, device, launches = [], [], [], [], {}
    for e in events:
        name = e.name()
        if _on_device(e):
            if not name.startswith(PROGRAM) and trace.event_kind(e) in (
                    "kernel", "copy"):
                device.append((trace._times(e)[0], _correlation(e)))
            continue
        if name.startswith(PROGRAM):
            s, end = trace._times(e)
            program.append((name[len(PROGRAM):], s, end, _thread(e)))
        elif name.startswith(trace.PREFIX):
            s, end = trace._times(e)
            threaded.append((name[len(trace.PREFIX):], s, end, _thread(e)))
        elif name.startswith("cu"):
            corr = _correlation(e)
            if corr:
                launches[corr] = _thread(e)
            if name in SYNC_CALLS:
                s, end = trace._times(e)
                syncs.append((name, s, end, _thread(e)))
    launched = sorted((s, launches.get(c)) for s, c in device)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(trace.Trace)}
    fields["kernels"] = [k for k in base.kernels
                         if not k[0].startswith(PROGRAM)]
    fields["spans"] = own_spans(base.spans, threaded)
    by_start = operator.itemgetter(1)
    return ProgramTrace(**fields, program=sorted(program, key=by_start),
                        syncs=sorted(syncs, key=by_start),
                        threaded=sorted(threaded, key=by_start),
                        launched=launched)


def own_spans(spans: list, threaded: list) -> list:
    """``spans`` less those recorded on another thread than the window's,
    which a profiler that records one thread never saw."""
    main = {t for n, _, _, t in threaded if n == trace.WINDOW}
    if len(main) != 1:
        return spans
    other = {(n, s, e) for n, s, e, t in threaded if t not in main}
    return [sp for sp in spans if sp not in other]


def read_profile(prof, outer_label: str) -> ProgramTrace:
    """``trace.read_profile`` and the program's events beside it."""
    return read_program(prof.profiler.kineto_results.events(),
                        _BASE_READ(prof, outer_label))


def all_threads() -> dict:
    """The profiler's keyword that records every thread, where the build
    has it."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return {}
    return {"experimental_config": cfg}


def start(self) -> None:
    """``Tracer.start``, recording every thread."""
    if not self.enabled:
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if self.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    self._prof = torch.profiler.profile(activities=acts, **all_threads())
    self._prof.__enter__()


def install() -> None:
    """Extend the traced run as the module's docstring says (again after
    an undo, never twice)."""
    trace.Tracer.start = start
    trace.read_profile = read_profile


def program_trace(run) -> ProgramTrace | None:
    """The run's trace where it holds the program's spans, else None."""
    tr = run.trace
    if isinstance(tr, ProgramTrace) and tr.program:
        return tr
    return None
