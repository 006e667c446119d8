"""served_p95_ms: the 95th percentile, over every request due in the
window, of the time from its scheduled arrival to its row on the host,
in milliseconds (host clock).  A request that failed, was refused or
never came counts as missing every limit; where missing ones reach the
95th percentile there is no number."""
import math

import numpy as np


def read(run):
    if not run.requests:
        return None
    lat = sorted((r.done - r.due) if r.ok else math.inf
                 for r in run.requests)
    if math.isinf(lat[math.ceil(0.95 * (len(lat) - 1))]):
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
