"""syncs_per_level: blocking CUDA runtime calls (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy) that start inside
the program's ``repro_torch.level`` spans, on the span's thread, over the
number of those spans in the window; the benchmark's own calls (its
byte-counting pauses) left out.  The engines' one-fetch-per-level design
reads 1, plus overflow retries (program span)."""
from bfsbench import program_trace

program_trace.install()


def read(run):
    tr = program_trace.program_trace(run)
    per_level = tr.level_syncs() if tr is not None else []
    if not per_level:
        return None
    return sum(len(calls) for calls in per_level) / len(per_level)
