"""queue_ms_p50.served: the median, over the served requests, of the
carrying wave's cut (``WaveStats.t_start``, stamped when the batcher cuts
and prepares the wave) less the request's due time, in milliseconds, on
``time.monotonic``: the wait for a wave to be cut (program span)."""
import numpy as np


def read(run):
    waits = [r.wave_start - r.due for r in run.requests
             if r.ok and r.wave_start is not None]
    if not waits:
        return None
    return 1e3 * float(np.median(waits))
