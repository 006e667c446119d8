"""finish_ms_p50.served: the median, over the window's waves, of the
batcher's ``repro_torch.batcher.finish`` span, in milliseconds: the
finisher's slicing of a wave's rows, the copy of each request's row and
the futures' resolution (program span, on the finisher's thread)."""
import numpy as np

from bfsbench import program_trace

program_trace.install()


def read(run):
    tr = program_trace.program_trace(run)
    spans = tr.named("batcher.finish") if tr is not None else []
    if not spans:
        return None
    return float(np.median([e - s for s, e, _ in spans])) / 1e6
