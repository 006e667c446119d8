"""k1_roofline: percent of the card's HBM bound that K1 reached: the
frozen byte count of every K1 call in the window (``yardstick.k1_bytes``
on the call's inputs, taken by the traced run's hook on
``msbfs_propagate_planes``) over 3.35 TB/s, against K1's device time in
the trace (its three launches, by symbol)."""
from bfsbench import yardstick


def read(run):
    if run.trace is None or run.probe is None or not run.probe.k1_bytes:
        return None
    ns = run.trace.kernel_ns(
        lambda name: any(s in name for s in yardstick.K1_SYMBOLS))
    return yardstick.roofline_share(sum(run.probe.k1_bytes), ns / 1e9)
