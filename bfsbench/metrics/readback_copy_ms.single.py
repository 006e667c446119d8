"""readback_copy_ms.single: mean duration, in milliseconds, of the
program's ``repro_torch.readback`` spans in the window, one a root in the
single-root cell: the final fetch of the level array, without the host's
count after it (program span).  ``readback_ms.single`` holds both."""
from bfsbench import program_trace

program_trace.install()


def read(run):
    tr = program_trace.program_trace(run)
    spans = tr.named("readback") if tr is not None else []
    if not spans:
        return None
    return sum(e - s for s, e, _ in spans) / len(spans) / 1e6
