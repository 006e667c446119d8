"""k4_roofline: percent of the card's HBM bound that K4 reached: the
frozen byte count of every K4 call in the window (``yardstick.k4_bytes``,
taken by the traced run's hook on ``bitmap_update``) over 3.35 TB/s,
against K4's device time in the trace (by symbol)."""
from bfsbench import yardstick


def read(run):
    if run.trace is None or run.probe is None or not run.probe.k4_bytes:
        return None
    ns = run.trace.kernel_ns(
        lambda name: any(s in name for s in yardstick.K4_SYMBOLS))
    return yardstick.roofline_share(sum(run.probe.k4_bytes), ns / 1e9)
