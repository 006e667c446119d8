"""The traced run's reduction: interval arithmetic, busy and idle time with
the benchmark's counting pauses cut out, and labelled gaps."""
from __future__ import annotations

import pytest

from bfsbench.trace import Trace, innermost, merge, subtract


def test_merge_and_subtract():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 8), (9, 9)]) == [(0, 3), (5, 8)]
    cut = [(2, 4), (6, 7)]
    assert subtract([(0, 10, "k"), (3, 5, "j"), (6, 7, "x")], cut) == [
        (0, 2, "k"), (4, 6, "k"), (7, 10, "k"), (4, 5, "j")]
    assert subtract([(0, 3, None)], [], keep_names=False) == [(0, 3)]


def test_innermost_takes_the_latest_opened():
    spans = sorted([(0, 100, "entry"), (10, 20, "statvec_fetch"),
                    (50, 90, "readback")])
    assert innermost(spans, [5, 15, 60, 95, 120]) == [
        "entry", "statvec_fetch", "readback", "entry", None]


def trace():
    # window 0..100; the benchmark counted in 40..50 (a kernel of its own
    # ran there); kernels and a copy; host spans for the labels
    return Trace(
        kernels=[("whole_scatter_kernel<2>", 10, 20), ("add_kernel", 15, 30),
                 ("unique_kernel", 42, 48), ("p3_planes_kernel", 60, 65)],
        copies=[("Memcpy DtoH (Device -> Pageable)", 70, 90)],
        spans=[("window", 0, 100), ("count", 40, 50), ("entry", 5, 95),
               ("statvec_fetch", 30, 40), ("readback", 66, 92)],
        outer_label="benchmark")


def test_window_busy_and_kernels():
    tr = trace()
    assert tr.window_ns() == 90
    assert tr.busy_ns() == 20 + 5 + 20          # 10..30, 60..65, 70..90
    assert tr.kernel_ns(lambda n: "whole" in n) == 10
    assert tr.kernel_ns(lambda n: True) == 10 + 15 + 5
    assert tr.by_name()[0] == ["Memcpy DtoH (Device -> Pageable)", 20e-9]


def test_idle_gaps_by_label():
    tr = trace()
    gaps = tr.gaps()
    assert gaps == [(0, 10), (30, 40), (50, 60), (65, 70), (90, 100)]
    by = dict((k, v) for k, v in tr.idle_by_label())
    assert by == pytest.approx({"benchmark": 10e-9, "statvec fetch": 10e-9,
                                "level step": 20e-9, "readback": 5e-9})
    assert sum(by.values()) == pytest.approx(
        (tr.window_ns() - tr.busy_ns()) * 1e-9)


def test_no_window_reads_nothing():
    tr = Trace(kernels=[("k", 0, 5)], copies=[], spans=[])
    assert tr.window_ns() == 0 and tr.busy_ns() == 0 and tr.gaps() == []


class _OldEvent:
    """A profiler event of a build without ``activity_type``, in
    microseconds."""

    def __init__(self, name, device, start_us, dur_us):
        self._n, self._d, self._s, self._u = name, device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._u


def test_events_of_a_build_without_activity_types():
    import torch

    from bfsbench.trace import _times, event_kind
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    want = {("bfsbench.window", cpu): "span",
            ("bfsbench.window", cuda): None,
            ("cudaLaunchKernel", cpu): None,
            ("aten::add", cpu): None,
            ("Memcpy DtoH (Device -> Pageable)", cuda): "copy",
            ("Memset (Device)", cuda): "copy",
            ("void whole_scatter_kernel<2>(WholeArgs)", cuda): "kernel"}
    for (name, dev), kind in want.items():
        assert event_kind(_OldEvent(name, dev, 3, 2)) == kind, name
    assert _times(_OldEvent("k", cuda, 3, 2)) == (3000, 5000)
