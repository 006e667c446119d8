"""Direction-optimizing scheduler (paper §IV-B "Scheduler"), host side.

Port of ``repro.core.scheduler.choose_mode_host``: the packed driver
fetches one stats vector per level and picks the next direction on the
host.  Policies: ``beamer`` (Beamer et al.: push->pull when
m_f * alpha > m_u, pull->push when n_f * beta < |V|; the default),
``paper`` (pull during the mid-term iterations), ``push`` and ``pull``.
"""
from __future__ import annotations

import dataclasses

PUSH = 0
PULL = 1


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "beamer"   # "beamer" | "paper" | "push" | "pull"
    alpha: float = 14.0
    beta: float = 24.0


def choose_mode_host(cfg: SchedulerConfig, prev_mode: int, n_f: int,
                     m_f: int, m_u: int, n: int, n_unvisited: int) -> int:
    """PUSH or PULL for the upcoming iteration, from host scalars."""
    if cfg.policy == "push":
        return PUSH
    if cfg.policy == "pull":
        return PULL
    if cfg.policy == "paper":
        grow = n_f * 20 > n
        ending = n_unvisited * 20 < n
        return PULL if (grow and not ending) else PUSH
    if prev_mode == PUSH and m_f * cfg.alpha > m_u:
        return PULL
    if prev_mode == PULL and n_f * cfg.beta < n:
        return PUSH
    return int(prev_mode)
