"""dispatch_ms_p50.served: the median, over the served requests, of the
carrying wave's entry into the engine (its ``run_batch`` call, stamped by
the benchmark) less the wave's cut (``WaveStats.t_start``), in
milliseconds, on ``time.monotonic``: the wait of a cut wave in the
pipeline's queue behind the running one (program span)."""
import numpy as np


def read(run):
    waits = [r.dispatch - r.wave_start for r in run.requests
             if r.ok and r.dispatch is not None and r.wave_start is not None]
    if not waits:
        return None
    return 1e3 * float(np.median(waits))
