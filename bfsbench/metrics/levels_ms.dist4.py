"""levels_ms.dist4: ``levels_ms`` on the distributed engine's leader: mean
time per wave, in milliseconds, to the last level's sync
(``last_stats["seconds"]`` of ``DistributedBFS.run_batch``, the gathered
readback excluded).  The loop's K2 count never pauses the leader, so
nothing is taken off (program span)."""
from pathlib import Path

from bfsbench import harness

read = harness.load_metric("levels_ms",
                           Path(__file__).resolve().parents[1]).read
