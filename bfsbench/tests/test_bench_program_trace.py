"""The program's spans in the traced run (``bfsbench/program_trace.py``):
they leave every existing reading as it was, put idle gaps down to the
program's phases, feed the metrics that read them, and are found on a
build whose profiler events lack ``activity_type``."""
from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from conftest import ROOT, run_tiny
from test_bench_trace import _OldEvent
from test_bench_trace import trace as base_trace

from bfsbench import drive, harness, program_trace
from bfsbench import trace as trace_mod
from bfsbench.program_trace import ProgramTrace

NEW = {"syncs_per_level", "syncs_per_level.single", "step_host_ms.single",
       "readback_copy_ms.single", "finish_ms_p50.served"}


@pytest.fixture
def undo_install(monkeypatch):
    """Whatever ``install()`` replaces in ``bfsbench.trace`` is put back
    after the test."""
    monkeypatch.setattr(trace_mod.Tracer, "start", trace_mod.Tracer.start)
    monkeypatch.setattr(trace_mod, "read_profile", trace_mod.read_profile)


def extended(tr, program=(), syncs=(), threaded=(), launched=()):
    fields = {f.name: getattr(tr, f.name)
              for f in dataclasses.fields(trace_mod.Trace)}
    return ProgramTrace(**fields, program=sorted(program, key=lambda e: e[1]),
                        syncs=sorted(syncs, key=lambda e: e[1]),
                        threaded=sorted(threaded, key=lambda e: e[1]),
                        launched=sorted(launched))


def threaded_of(tr, thread=1):
    return [(n, s, e, thread) for n, s, e in tr.spans]


def fake_run(tr):
    """A run of two closed-loop units and two served requests around
    ``tr``, with every counter the existing metrics read."""
    run = harness.Run(cell={}, config={}, mix={}, seed=0,
                      device=torch.device("cpu"))
    run.units = [drive.Unit(0.0, 0.5, np.array([1, 2]), True, 0.2, 0.01),
                 drive.Unit(0.5, 1.2, np.array([3]), True, 0.3, 0.0)]
    run.requests = [drive.Request(1, 0.0, 0.4, True, 0.1, 0, 0.2),
                    drive.Request(2, 0.1, 0.9, True, 0.3, 1, 0.5)]
    run.trav = np.arange(10)
    run.window_s, run.setup_s = 1.2, 3.0
    run.batcher = {"waves": 2, "errors": 0, "requests": 2}
    run.probe = types.SimpleNamespace(k1_bytes=[10 ** 6], k4_bytes=[10 ** 5])
    run.trace = tr
    return run


def existing_readings(run) -> dict:
    spec = harness.load_spec(ROOT)
    return {m["name"]: harness.load_metric(m["name"]).read(run)
            for m in spec["end_to_end"] + spec["per_layer"]
            if m["name"] not in NEW}


# Program spans and syncs that hold none of the base trace's gap middles
# (5, 35, 55, 67, 95), on the thread of the benchmark's spans.
QUIET = [("level", 6, 34, 1), ("step", 10, 30, 1), ("readback", 70, 90, 1)]
SYNCS = [("cudaStreamSynchronize", 20, 21, 1), ("cudaMemcpy", 80, 85, 1)]


@pytest.mark.parametrize("program", [[], QUIET], ids=["parent", "quiet"])
def test_program_spans_leave_existing_readings(program, undo_install):
    base = base_trace()
    tr = extended(base, program, SYNCS, threaded_of(base),
                  [(10, 1), (15, 1), (42, 1), (60, 1), (70, 1)])
    assert existing_readings(fake_run(tr)) == existing_readings(
        fake_run(base))
    assert tr.idle_by_label() == base.idle_by_label()
    assert (tr.busy_ns(), tr.window_ns(), tr.gaps(), tr.by_name()) == (
        base.busy_ns(), base.window_ns(), base.gaps(), base.by_name())


def test_gaps_under_a_program_span_take_its_name():
    base = base_trace()
    tr = extended(base, [("level", 50, 62, 1), ("statvec_fetch", 32, 38, 1)],
                  threaded=threaded_of(base))
    by = dict(tr.idle_by_label())
    assert by == pytest.approx({
        "level step": 10e-9, "repro_torch.statvec_fetch": 10e-9,
        "repro_torch.level": 10e-9, "readback": 5e-9, "benchmark": 10e-9})
    assert sum(by.values()) == pytest.approx(
        sum(v for _, v in base.idle_by_label()))


@pytest.mark.parametrize("launcher,label", [
    (2, "level step"),                 # the dispatcher's: its entry span
    (None, "repro_torch.batcher.finish"),   # unknown: the innermost of all
])
def test_gap_goes_to_the_launching_thread(launcher, label):
    """A gap ending in an operation launched on the dispatcher (thread 2)
    is put down to the dispatcher's spans, not to the finisher's (thread
    3) span open at the same time."""
    base = trace_mod.Trace(kernels=[("k", 0, 10), ("k", 20, 30)], copies=[],
                           spans=[("window", 0, 30), ("entry", 0, 30)])
    tr = extended(base, [("batcher.finish", 12, 18, 3)],
                  threaded=[("window", 0, 30, 1), ("entry", 0, 30, 2)],
                  launched=[(0, 2), (20, launcher)])
    assert tr.idle_by_label() == [[label, pytest.approx(10e-9)]]


def level_trace():
    """A window 0..1000 with two levels on thread 1 (the second retried),
    a readback, a counting pause of the benchmark inside the first level
    with the probe's synchronisation before it, and two finished waves
    on the finisher's thread."""
    base = trace_mod.Trace(
        kernels=[("k", 0, 1000)], copies=[],
        spans=[("window", 0, 1000), ("count", 40, 50), ("entry", 0, 900)])
    program = [("level", 10, 110, 1), ("step", 12, 60, 1),
               ("statvec_fetch", 60, 100, 1),
               ("level", 200, 400, 1), ("step", 205, 240, 1),
               ("statvec_fetch", 240, 260, 1), ("retry", 260, 380, 1),
               ("readback", 500, 800, 1), ("count", 800, 850, 1),
               ("batcher.finish", 900, 910, 5),
               ("batcher.finish", 920, 950, 5),
               ("batcher.finish", 960, 964, 5)]
    syncs = [("cudaStreamSynchronize", 30, 31, 1),   # expand's scalar copy
             ("cudaDeviceSynchronize", 38, 39, 1),   # the probe's, then
             ("cudaStreamSynchronize", 45, 46, 1),   # its counting
             ("cudaStreamSynchronize", 95, 99, 1),   # the statvec fetch
             ("cudaStreamSynchronize", 250, 255, 1),
             ("cudaStreamSynchronize", 370, 379, 1),  # the retry's fetch
             ("cudaStreamSynchronize", 300, 301, 2),  # another thread's
             ("cudaStreamSynchronize", 790, 799, 1)]  # the readback's
    threaded = [("window", 0, 1000, 1), ("count", 40, 50, 1),
                ("entry", 0, 900, 1)]
    return extended(base, program, syncs, threaded)


@pytest.mark.parametrize("metric,value", [
    ("syncs_per_level", (2 + 2) / 2),
    ("syncs_per_level.single", (2 + 2) / 2),
    # level 1: 100 - fetch 40 - counting 10 - the syncs at 30 and 38
    # outside both; level 2: 200 - fetch and retry 140 (its syncs inside)
    ("step_host_ms.single", ((100 - 40 - 10 - 2) + (200 - 140)) / 2 / 1e6),
    ("readback_copy_ms.single", 300 / 1e6),
    ("finish_ms_p50.served", 10 / 1e6),
])
def test_new_metric_reads(metric, value, undo_install):
    read = harness.load_metric(metric).read
    assert read(fake_run(level_trace())) == pytest.approx(value)
    # the parent's program has no spans: nothing to read, and no error
    assert read(fake_run(base_trace())) is None
    assert read(fake_run(extended(base_trace()))) is None


class _ThreadedEvent(_OldEvent):
    """A profiler event of a build without ``activity_type``, with its
    thread and correlation id."""

    def __init__(self, name, device, start_us, dur_us, thread=1, corr=0):
        super().__init__(name, device, start_us, dur_us)
        self._t, self._c = thread, corr

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c


def test_reader_on_a_build_without_activity_types(undo_install):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _ThreadedEvent("bfsbench.window", cpu, 0, 100),
        _ThreadedEvent("bfsbench.window", cuda, 0, 100),
        _ThreadedEvent("repro_torch.level", cpu, 10, 50, thread=3),
        _ThreadedEvent("repro_torch.level", cuda, 12, 40),  # the mirror
        _ThreadedEvent("cudaLaunchKernel", cpu, 20, 1, thread=3, corr=7),
        _ThreadedEvent("cudaStreamSynchronize", cpu, 30, 5, thread=3),
        _ThreadedEvent("aten::add", cpu, 19, 3, thread=3),
        _ThreadedEvent("void whole_scatter_kernel<2>(WholeArgs)", cuda, 25,
                       4, corr=7),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tr = program_trace.read_profile(prof, "benchmark")
    assert isinstance(tr, ProgramTrace)
    assert [k[0] for k in tr.kernels] == [
        "void whole_scatter_kernel<2>(WholeArgs)"]
    # the hazard install() exists for: the benchmark's own reader takes
    # the program span's device mirror for a kernel
    assert "repro_torch.level" in [
        k[0] for k in program_trace._BASE_READ(prof, "benchmark").kernels]
    assert tr.program == [("level", 10000, 60000, 3)]
    assert tr.syncs == [("cudaStreamSynchronize", 30000, 35000, 3)]
    assert tr.threaded == [("window", 0, 100000, 1)]
    assert tr.launched == [(25000, 3)]
    assert tr.level_syncs() == [[("cudaStreamSynchronize", 30000, 35000)]]


def _events_with_a_dispatcher(with_dispatcher: bool) -> list:
    """The main thread (1) opens the window; a dispatcher (2) launches a
    kernel of the benchmark's byte counting inside its ``bfsbench.count``
    pause, a kernel of the program, and waits between them."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = _ThreadedEvent
    main = [ev("bfsbench.window", cpu, 0, 100, thread=1),
            ev("cudaLaunchKernel", cpu, 1, 1, thread=2, corr=1),
            ev("cudaLaunchKernel", cpu, 45, 1, thread=2, corr=2),
            ev("cudaLaunchKernel", cpu, 70, 1, thread=2, corr=3),
            ev("k_program", cuda, 0, 30, corr=1),
            ev("unique_kernel", cuda, 50, 10, corr=2),
            ev("k_program", cuda, 80, 20, corr=3)]
    dispatcher = [ev("bfsbench.entry", cpu, 0, 100, thread=2),
                  ev("bfsbench.count", cpu, 40, 30, thread=2)]
    return main + (dispatcher if with_dispatcher else [])


def _profile_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_another_threads_counting_pause_is_not_cut(undo_install):
    """Recording every thread brings in the dispatcher's spans; the
    existing readings stay those of the main thread's profile (a counting
    pause of the dispatcher's was never cut), and the gap inside it is
    the benchmark's count."""
    one = program_trace._BASE_READ(
        _profile_of(_events_with_a_dispatcher(False)), "batcher")
    tr = program_trace.read_profile(
        _profile_of(_events_with_a_dispatcher(True)), "batcher")
    assert tr.spans == one.spans == [("window", 0, 100000)]
    assert (tr.window_ns(), tr.busy_ns(), tr.gaps()) == (
        one.window_ns(), one.busy_ns(), one.gaps())
    run, run_one = fake_run(tr), fake_run(one)
    assert existing_readings(run) == existing_readings(run_one)
    assert dict(tr.idle_by_label()) == pytest.approx({
        "level step": 20e-6, "bfsbench.count": 20e-6})
    assert tr.pauses() == [(40000, 70000)]


def test_a_real_profile_keeps_the_main_threads_spans(undo_install):
    """The same on this build's own profiler: a worker's counting pause
    is recorded with every thread, and left out of the ``Trace``'s spans."""
    import threading
    tracer = trace_mod.Tracer(True, torch.device("cpu"))
    program_trace.install()
    tracer.start()
    with tracer.span("window"):
        worker = threading.Thread(target=lambda: tracer.span(
            "count").__enter__().__exit__(None, None, None))
        with tracer.span("entry"):
            worker.start()
            worker.join()
    tr = tracer.stop()
    assert isinstance(tr, ProgramTrace)
    assert sorted(n for n, *_ in tr.spans) == ["entry", "window"]
    threads = {n: t for n, _, _, t in tr.threaded}
    if "count" not in threads:
        pytest.skip("this build's profiler records one thread only")
    assert threads["count"] != threads["window"] == threads["entry"]
    assert tr.cut() == [] and len(tr.pauses()) == 1


def test_every_traced_cell_installs_the_program_reader(monkeypatch):
    """Each cell of BENCHMARK.json loads, with its per-layer metrics, a
    module that calls ``install()``: without it the old reader would
    count the program spans' device mirrors as kernels."""
    spec = harness.load_spec(ROOT)
    for cell in spec["workloads"]:
        monkeypatch.setattr(trace_mod, "read_profile",
                            program_trace._BASE_READ)
        monkeypatch.setattr(trace_mod.Tracer, "start",
                            program_trace._BASE_START)
        metrics = harness.metrics_of(spec, cell["name"], True)
        assert metrics, cell["name"]
        for m in metrics:
            harness.load_metric(m["name"])
        assert trace_mod.read_profile is program_trace.read_profile, cell
        assert trace_mod.Tracer.start is program_trace.start, cell


def test_install_records_every_thread(undo_install):
    program_trace.install()
    assert trace_mod.Tracer.start is program_trace.start
    assert trace_mod.read_profile is program_trace.read_profile
    assert "experimental_config" in program_trace.all_threads()


def add_to(bench_copy, cells: dict) -> None:
    """List each tiny cell in the workloads of the given metrics."""
    path = bench_copy.parent / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    for m in spec["per_layer"]:
        for cell, names in cells.items():
            if m["name"] in names:
                m["workloads"].append(cell)
    path.write_text(json.dumps(spec))


def test_tiny_traced_cells_report_the_program_spans(bench_copy,
                                                    undo_install):
    """On the CPU's plain paths: the program's spans reach the readers of
    the single-root and the served cell (no CUDA runtime call on the CPU,
    so no sync)."""
    add_to(bench_copy, {
        "tiny.single": ("syncs_per_level.single", "step_host_ms.single",
                        "readback_copy_ms.single"),
        "tiny.wave32": ("syncs_per_level",),
        "tiny.served": ("finish_ms_p50.served",)})
    for cell, want in [
            ("tiny.single", {"step_host_ms.single", "readback_copy_ms.single"}),
            ("tiny.wave32", set()),
            ("tiny.served", {"finish_ms_p50.served"})]:
        out = run_tiny(bench_copy, cell, seed=2**31 + 21, trace=True)
        assert out["correct"], out["checks"]
        got = out["metrics"]
        assert all(got[m]["value"] > 0 for m in want), (cell, got)
        syncs = [m for m in got if m.startswith("syncs_per_level")]
        assert all(got[m]["value"] == 0 for m in syncs), got
        labels = {label for label, _ in out["breakdown"]["idle_gaps"]}
        assert labels and all(isinstance(lb, str) for lb in labels)
