"""The traced run's record of which thread launched each device
operation, for traces in which two operations start at the same
nanosecond and only one launch of the two is on record: on four cards,
NCCL's kernels on their own stream beside the step's.
``program_trace.read_program`` sorts the (start, thread) pairs whole, and a
thread of None beside a thread id at the same start cannot be ordered, so
the traced run fails.  ``install()`` puts in its place the same reading
with a thread of None ordered before any thread id at the same start:
wherever the original reads a trace, this reads it alike.  The
four-card cell's metrics install it; no other cell loads it.
"""
from __future__ import annotations

import dataclasses
import operator

from bfsbench import program_trace, trace

_BASE = program_trace.read_program


def read_program(events, base: trace.Trace) -> program_trace.ProgramTrace:
    """``program_trace.read_program``, with ``launched`` sorted by start
    and then by thread, None first."""
    program, syncs, threaded, device, launches = [], [], [], [], {}
    pt = program_trace
    for e in events:
        name = e.name()
        if pt._on_device(e):
            if not name.startswith(pt.PROGRAM) and trace.event_kind(e) in (
                    "kernel", "copy"):
                device.append((trace._times(e)[0], pt._correlation(e)))
            continue
        if name.startswith(pt.PROGRAM):
            s, end = trace._times(e)
            program.append((name[len(pt.PROGRAM):], s, end, pt._thread(e)))
        elif name.startswith(trace.PREFIX):
            s, end = trace._times(e)
            threaded.append((name[len(trace.PREFIX):], s, end,
                             pt._thread(e)))
        elif name.startswith("cu"):
            corr = pt._correlation(e)
            if corr:
                launches[corr] = pt._thread(e)
            if name in pt.SYNC_CALLS:
                s, end = trace._times(e)
                syncs.append((name, s, end, pt._thread(e)))
    launched = sorted(((s, launches.get(c)) for s, c in device),
                      key=lambda p: (p[0], p[1] is not None, p[1] or 0))
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(trace.Trace)}
    fields["kernels"] = [k for k in base.kernels
                         if not k[0].startswith(pt.PROGRAM)]
    fields["spans"] = pt.own_spans(base.spans, threaded)
    by_start = operator.itemgetter(1)
    return pt.ProgramTrace(**fields, program=sorted(program, key=by_start),
                           syncs=sorted(syncs, key=by_start),
                           threaded=sorted(threaded, key=by_start),
                           launched=launched)


def install() -> None:
    """Read the traced run's program events with :func:`read_program`
    (and ``program_trace``'s extension of the traced run installed)."""
    program_trace.install()
    program_trace.read_program = read_program
