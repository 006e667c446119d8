"""exchange_ms.dist4: device time per wave, in milliseconds, of NCCL's
kernels on the leader's card: the crossbar's all-to-alls, the pull's
frontier all-gathers, the statvec all-reduces, the roots' broadcast and
the readback's gather, waits for the other ranks included (device
trace)."""
from bfsbench import launch_order, yardstick_dist

launch_order.install()


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not run.units:
        return None
    ns = tr.kernel_ns(yardstick_dist.is_nccl)
    if ns <= 0:
        return None
    return ns / 1e6 / len(run.units)
