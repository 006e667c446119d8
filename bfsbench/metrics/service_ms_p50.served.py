"""service_ms_p50.served: the median, over the served requests, of the
request's row on the host less its wave's entry into the engine, in
milliseconds, on ``time.monotonic``: the wave's traversal, its rows'
readback and the batcher's hand-over (host clock)."""
import numpy as np


def read(run):
    waits = [r.done - r.dispatch for r in run.requests
             if r.ok and r.dispatch is not None]
    if not waits:
        return None
    return 1e3 * float(np.median(waits))
