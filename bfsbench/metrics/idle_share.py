"""idle_share: percent of the traced window in which nothing ran on the
device: 1 - (union of kernel and copy intervals) / window, the
benchmark's own counting pauses cut out of both (device trace)."""


def read(run):
    tr = run.trace
    if tr is None or not (tr.kernels or tr.copies) or tr.window_ns() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns())
