"""glue_device_ms.dist4: device time per wave, in milliseconds, on the
leader's card of every kernel that is neither one of the port's own
(``glue_device_ms``'s rule) nor NCCL's: the sharded expansion's scans,
searches and gathers, the commit and the readback's reorder.  It holds
the loop's K2 count in a traced window, a few reductions a pull level
(device trace)."""
from pathlib import Path

from bfsbench import harness, launch_order, yardstick_dist

launch_order.install()

_GLUE = harness.load_metric("glue_device_ms",
                            Path(__file__).resolve().parents[1]).is_glue


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not run.units:
        return None
    ns = tr.kernel_ns(lambda n: _GLUE(n) and not yardstick_dist.is_nccl(n))
    return ns / 1e6 / len(run.units)
