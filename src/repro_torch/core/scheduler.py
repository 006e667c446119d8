"""Direction-optimizing scheduler (paper §IV-B "Scheduler").

Port of ``repro.core.scheduler``.  The packed drivers fetch one stats
vector per level and pick the next direction on the host
(``choose_mode_host``); the bool-plane baseline keeps the reference's
device-side ``choose_mode``, whose result it fetches.  Policies:
``beamer`` (Beamer et al.: push->pull when m_f * alpha > m_u, pull->push
when n_f * beta < |V|; the default), ``paper`` (pull during the mid-term
iterations), ``push`` and ``pull``.
"""
from __future__ import annotations

import dataclasses

import torch

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


def choose_mode(cfg: SchedulerConfig, prev_mode: torch.Tensor, n_f, m_f, m_u,
                n, n_unvisited) -> torch.Tensor:
    """PUSH or PULL for the upcoming iteration as an int32 tensor on
    ``prev_mode``'s device.  The stats may be host scalars or tensors; the
    comparisons run where they are, as in the reference (whose callers
    pass the numpy scalars they fetched).  Must stay semantically
    identical to :func:`choose_mode_host`."""
    dev = prev_mode.device

    def const(mode: int) -> torch.Tensor:
        return torch.tensor(mode, dtype=torch.int32, device=dev)

    def on_dev(cond) -> torch.Tensor:
        return torch.as_tensor(cond, device=dev)

    if cfg.policy == "push":
        return const(PUSH)
    if cfg.policy == "pull":
        return const(PULL)
    if cfg.policy == "paper":
        grow = on_dev(n_f * 20 > n)
        ending = on_dev(n_unvisited * 20 < n)
        return torch.where(grow & ~ending, const(PULL), const(PUSH))
    to_pull = (prev_mode == PUSH) & on_dev(m_f * cfg.alpha > m_u)
    to_push = (prev_mode == PULL) & on_dev(n_f * cfg.beta < n)
    return torch.where(to_pull, const(PULL),
                       torch.where(to_push, const(PUSH),
                                   prev_mode.to(torch.int32)))
