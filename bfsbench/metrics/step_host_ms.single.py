"""step_host_ms.single: mean host work, in milliseconds, of the program's
``repro_torch.level`` spans in the window: each span less the time under
its ``statvec_fetch`` and ``retry`` children, under the blocking runtime
calls that start inside it on its thread (the hidden syncs' waits) and
under the benchmark's counting pauses.  What is left is the host choosing
the level's mode and budget and enqueueing its device work (program
span)."""
from bfsbench import program_trace
from bfsbench.trace import length, merge

program_trace.install()

_WAITS = ("statvec_fetch", "retry")


def read(run):
    tr = program_trace.program_trace(run)
    levels = tr.named("level") if tr is not None else []
    if not levels:
        return None
    waits = tr.inside(levels, [ev for ev in tr.program if ev[0] in _WAITS])
    syncs = tr.inside(levels, tr.syncs)
    paused = tr.pauses()
    own = []
    for (s, e, _), kids, calls in zip(levels, waits, syncs):
        held = [(ws, we) for _, ws, we in kids + calls] + paused
        own.append((e - s) - length(merge(
            (max(ws, s), min(we, e)) for ws, we in held)))
    return sum(own) / len(own) / 1e6
