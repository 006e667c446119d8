"""syncs_per_level.dist4: ``syncs_per_level`` on the distributed engine's
leader: blocking CUDA runtime calls inside its ``repro_torch.level``
spans, over the number of those spans in the window.  The engine's
design reads 1 (the batched statvec's fetch); each further call is a
hidden sync.  Read over the waves the ``dist_batch`` loop recorded
(``dist_calls`` on the probe); silent where it recorded none (program
span)."""
from pathlib import Path

from bfsbench import harness, launch_order

launch_order.install()

_BASE = harness.load_metric("syncs_per_level",
                            Path(__file__).resolve().parents[1])


def read(run):
    if not getattr(run.probe, "dist_calls", None):
        return None
    return _BASE.read(run)
