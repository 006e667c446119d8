"""readback_ms.dist4: the program's ``repro_torch.readback`` spans in the
window, in milliseconds a wave of the distributed engine: the level
blocks gathered to the leader, put into vertex order on its card and
copied into the page-locked host blocks.  Read over the waves the
``dist_batch`` loop recorded (``dist_calls`` on the probe); silent where
it recorded none (program span)."""
from bfsbench import launch_order, program_trace

launch_order.install()


def read(run):
    calls = getattr(run.probe, "dist_calls", None)
    tr = program_trace.program_trace(run)
    spans = tr.named("readback") if tr is not None and calls else []
    if not spans:
        return None
    return sum(e - s for s, e, _ in spans) / len(spans) / 1e6
