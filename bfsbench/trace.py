"""The traced run: host spans the benchmark opens around its calls into the
program, the profiler's device events, and the reduction of both to
busy time, idle gaps and device time by kernel.

Spans are ``torch.profiler.record_function`` ranges named ``bfsbench.*``,
so they share the device events' clock.  Two spans have a fixed meaning:
``bfsbench.window`` is the measured window, and ``bfsbench.count`` is a
pause in which the benchmark counted a kernel call's bytes between two
synchronisations: whatever ran on the device inside one is the
benchmark's own work, and it is cut out of the window, the busy time and
every kernel's time.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

PREFIX = "bfsbench."
WINDOW = "window"
COUNT = "count"

# How an idle gap is labelled by the innermost span open on the host.
SPAN_LABELS = {"entry": "level step", "statvec_fetch": "statvec fetch",
               "readback": "readback"}


@dataclasses.dataclass
class Trace:
    """Events of one traced window, in nanoseconds on one clock.

    kernels/copies: (name, start, end) on the device; spans: (name, start,
    end) of the benchmark's host spans, the prefix taken off."""

    kernels: list
    copies: list
    spans: list
    outer_label: str = "benchmark"

    # -- the window and what is cut out of it -----------------------------
    def window(self) -> tuple[int, int] | None:
        w = [(s, e) for n, s, e in self.spans if n == WINDOW]
        return (min(s for s, _ in w), max(e for _, e in w)) if w else None

    def cut(self) -> list:
        """Merged intervals of the window that are the benchmark's own."""
        win = self.window()
        if win is None:
            return []
        return merge([(max(s, win[0]), min(e, win[1]))
                      for n, s, e in self.spans if n == COUNT])

    def window_ns(self) -> int:
        win = self.window()
        if win is None:
            return 0
        return win[1] - win[0] - length(self.cut())

    def _kept(self, events) -> list:
        """``events`` clipped to the window, with the cut taken out."""
        win = self.window()
        if win is None:
            return []
        return subtract([(max(s, win[0]), min(e, win[1]), name)
                         for name, s, e in events], self.cut())

    def busy_ns(self) -> int:
        """Union of kernel and copy intervals inside the kept window."""
        return length(merge([(s, e) for s, e, _ in
                             self._kept(self.kernels + self.copies)]))

    def kernel_ns(self, match) -> int:
        """Summed device time of the kernels whose name ``match`` accepts."""
        return sum(e - s for s, e, name in self._kept(self.kernels)
                   if match(name))

    def by_name(self, limit: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        tot: dict = {}
        for s, e, name in self._kept(self.kernels + self.copies):
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:limit]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def gaps(self) -> list:
        """Idle intervals of the kept window: (start, end)."""
        win = self.window()
        if win is None:
            return []
        busy = merge([(s, e) for s, e, _ in
                      self._kept(self.kernels + self.copies)])
        return subtract([(win[0], win[1], None)],
                        merge(busy + self.cut()), keep_names=False)

    def idle_by_label(self, limit: int = 10) -> list:
        """Idle seconds summed by what the host was doing, longest first:
        the innermost benchmark span open at each gap's middle."""
        spans = sorted((s, e, n) for n, s, e in self.spans
                       if n not in (WINDOW, COUNT))
        gaps = self.gaps()
        tot: dict = {}
        for (gs, ge), name in zip(
                gaps, innermost(spans, [(gs + ge) // 2 for gs, ge in gaps])):
            label = SPAN_LABELS.get(name, name) if name else self.outer_label
            tot[label] = tot.get(label, 0) + (ge - gs)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:limit]
        return [[label, ns / 1e9] for label, ns in top]


# -- interval arithmetic ------------------------------------------------------

def merge(intervals) -> list:
    """Sorted union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def subtract(events, cut, keep_names: bool = True) -> list:
    """(start, end, name) events with the merged intervals ``cut`` taken
    out, split where a cut lies inside one; (start, end) pairs when
    ``keep_names`` is False."""
    out: list = []
    cut = list(cut)
    starts = [s for s, _ in cut]
    for s, e, name in events:
        if e <= s:
            continue
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        cur = s
        while i < len(cut) and cut[i][0] < e:
            cs, ce = cut[i]
            if ce > cur:
                if cs > cur:
                    out.append((cur, cs, name))
                cur = max(cur, ce)
            i += 1
        if cur < e:
            out.append((cur, e, name))
    return out if keep_names else [(s, e) for s, e, _ in out]


def innermost(spans, points) -> list:
    """For each point, the name of the latest-opened span of ``spans``
    (sorted (start, end, name)) that contains it, or None."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: list = [None] * len(points)
    active: list = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(spans) and spans[j][0] <= p:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[1] > p]
        if active:
            out[i] = max(active, key=lambda sp: sp[0])[2]
    return out


# -- recording ----------------------------------------------------------------

class Tracer:
    """The benchmark's spans and, when ``enabled``, the profiler over the
    window.  Disabled, every span is a no-op."""

    def __init__(self, enabled: bool, device: torch.device,
                 outer_label: str = "benchmark"):
        self.enabled = enabled
        self.device = device
        self.outer_label = outer_label
        self._prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> Trace | None:
        if self._prof is None:
            return None
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        return read_profile(prof, self.outer_label)


_KERNEL_KINDS = {"kernel"}
_COPY_KINDS = {"gpu_memcpy", "gpu_memset"}
_COPY_NAMES = ("Memcpy", "Memset")


def _times(e) -> tuple[int, int]:
    """An event's start and end in nanoseconds (builds of PyTorch that
    keep microseconds only have ``start_us``/``duration_us``)."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def event_kind(e) -> str | None:
    """``kernel``, ``copy`` or ``span`` (a benchmark span on the host), or
    None.  By the event's activity type where the build reports it; else
    by its device and name: a device event is a copy where its name says
    so and a kernel otherwise, except the device's mirror of a
    benchmark span."""
    name = e.name()
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind in _KERNEL_KINDS:
            return "kernel"
        if kind in _COPY_KINDS:
            return "copy"
        if kind == "user_annotation" and name.startswith(PREFIX):
            return "span"
        return None
    on_device = e.device_type() != torch.autograd.DeviceType.CPU
    if name.startswith(PREFIX):
        return None if on_device else "span"
    if not on_device:
        return None
    return "copy" if name.startswith(_COPY_NAMES) else "kernel"


def read_profile(prof, outer_label: str) -> Trace:
    """Device events and benchmark spans of a finished profiler."""
    kernels, copies, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = event_kind(e)
        if kind is None:
            continue
        name = e.name()
        s, end = _times(e)
        if kind == "kernel":
            kernels.append((name, s, end))
        elif kind == "copy":
            copies.append((name, s, end))
        else:
            spans.append((name[len(PREFIX):], s, end))
    return Trace(kernels, copies, spans, outer_label)
