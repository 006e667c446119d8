"""k2_roofline.dist4: percent of the card's HBM bound that K2, the
distributed pull's row-tiled propagate, reached on the leader's card: the
frozen byte count of every K2 call in the window
(``yardstick_dist.k2_bytes`` on the call's inputs, queued on the card
by the loop's hook on ``msbfs_propagate_planes_tiled`` without a pause)
over 3.35 TB/s, against K2's device time in the trace (device trace)."""
from bfsbench import launch_order, yardstick, yardstick_dist

launch_order.install()


def read(run):
    k2 = getattr(run.probe, "k2_bytes", None)
    if run.trace is None or not k2:
        return None
    ns = run.trace.kernel_ns(
        lambda name: any(s in name for s in yardstick_dist.K2_SYMBOLS))
    return yardstick.roofline_share(sum(k2), ns / 1e9)
