"""idle_share.dist4: ``idle_share`` on the leader's card: percent of the
traced window in which nothing ran there.  NCCL's kernels count as busy
while they wait for the other ranks (device trace)."""
from pathlib import Path

from bfsbench import harness, launch_order

launch_order.install()

read = harness.load_metric("idle_share",
                           Path(__file__).resolve().parents[1]).read
