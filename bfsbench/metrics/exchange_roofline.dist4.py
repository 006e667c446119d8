"""exchange_roofline.dist4: percent of one card's NVLink bound (450 GB/s
a direction, ``yardstick_dist``) that the leader's collectives reached
while the traversal ran: the bytes the leader sent in the window's calls
(the sum of each call's ``last_stats["exchange_bytes"]``, recorded by the
loop on the probe; the readback's gather, in which the leader only
receives, left out) over 450 GB/s, against NCCL's device time on the
leader's card outside the program's ``readback`` spans.  The time holds
the waits for the other ranks (device trace)."""
from bfsbench import launch_order, program_trace, trace, yardstick_dist

launch_order.install()


def read(run):
    calls = getattr(run.probe, "dist_calls", None)
    tr = program_trace.program_trace(run)
    if tr is None or not calls:
        return None
    sent = sum(v for c in calls
               for kind, v in c.get("exchange_bytes", {}).items()
               if kind != "gather")
    readback = trace.merge((s, e) for s, e, _ in tr.named("readback"))
    ns = sum(e - s for s, e, name in tr._kept(tr.kernels)
             if yardstick_dist.is_nccl(name)
             and not any(rs <= s < re for rs, re in readback))
    return yardstick_dist.link_share(sent, ns / 1e9)
