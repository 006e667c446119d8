"""ScalaBFS experiment configurations (the paper's own system); a copy of
``repro.configs.scalabfs``.

Mirrors the paper's evaluated configurations: PC count (here: mesh ranks /
graph shards), PEs per PC (shards per rank), dispatcher flavor (full vs
multi-layer crossbar), scheduler policy, and the workload suite of
Table I.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.bfs_distributed import DistConfig
from repro_torch.core.scheduler import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class ScalaBFSConfig:
    name: str
    num_shards: int            # HBM PC analogue (ranks / graph shards)
    pes_per_shard: int         # PE analogue (shards per PC)
    dispatch: str = "bitmap"   # bitmap | queue
    crossbar: str = "staged"   # staged (multi-layer) | flat (full)
    policy: str = "beamer"     # hybrid scheduler
    datasets: tuple = ("rmat18-8", "rmat18-16", "rmat18-32", "rmat18-64")

    def dist_config(self) -> DistConfig:
        return DistConfig(dispatch=self.dispatch, crossbar=self.crossbar,
                          scheduler=SchedulerConfig(policy=self.policy))


# The paper's Table II configurations, mapped to mesh shards.
CONFIGS = {
    # 16 PC / 32 PE
    "scalabfs-16pc-32pe": ScalaBFSConfig("scalabfs-16pc-32pe", 16, 2),
    # 32 PC / 32 PE
    "scalabfs-32pc-32pe": ScalaBFSConfig("scalabfs-32pc-32pe", 32, 1),
    # 32 PC / 64 PE (peak config; 3-layer 4x4 crossbar in the paper)
    "scalabfs-32pc-64pe": ScalaBFSConfig("scalabfs-32pc-64pe", 32, 2),
    # full-pod and multi-pod scaling targets for the dry-run
    "scalabfs-pod": ScalaBFSConfig("scalabfs-pod", 256, 2),
    "scalabfs-2pod": ScalaBFSConfig("scalabfs-2pod", 512, 2),
}
