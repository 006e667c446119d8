"""AdamW with global-norm clipping and cosine schedule (port of
``repro.optim.adamw``).

The state is ``{"m", "v", "step"}``: ``m`` and ``v`` float32 tensors
keyed by the ``LM``'s parameter names (``segments.i.j.attn.wq``, ...),
``step`` an int32 scalar tensor.  :func:`apply_updates` does the
reference's arithmetic in its order, in float32, one parameter at a time
(as its per-leaf ``tree_map``), and writes the new parameters, ``m`` and
``v`` in place: the counterpart of the reference's donated state.  The
per-leaf order keeps the float32 temporaries to a few copies of the
largest parameter rather than of the whole model.

Sharded parameters (``DTensor``s) keep moments sharded like themselves,
and the update runs on each rank's blocks.  :func:`global_norm` stays
the norm over whole parameters: each block's sum of squares is a partial
sum that DTensor reduces over the ranks before the square root.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params) -> dict:
    """Zero ``m`` and ``v`` (float32, on each parameter's device) and a
    zero int32 ``step``; ``params`` is an ``LM`` or a name -> tensor
    mapping."""
    named = _named(params)
    dev = next(iter(named.values())).device

    def zeros(p):
        if isinstance(p, DTensor):      # sharded like its parameter
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": {k: zeros(p) for k, p in named.items()},
        "v": {k: zeros(p) for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _decay_mask(name: str) -> bool:
    """No weight decay on norms / biases / scalar gains: the reference
    tests its leaf's key, the last component of the port's name."""
    leaf = name.split(".")[-1]
    return not any(s in leaf for s in
                   ("ln", "bias", "_b", "lam", "a_log", "d_skip", "dt_bias"))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the float32 sum of squares over ``tensors`` (whole
    tensors: over every rank's block of a DTensor)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(params, grads: dict, state: dict, cfg: AdamWConfig):
    """Returns (params, new_state, metrics).  ``grads`` is keyed like
    ``state["m"]``; the parameters and ``state``'s ``m`` and ``v`` are
    updated in place, and ``new_state`` holds them with the next step."""
    named = _named(params)
    step = state["step"] + 1
    gnorm = global_norm(grads[k] for k in named)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for name, p in named.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = torch.div(m, bc1)
        delta.div_(torch.div(v, bc2).sqrt_().add_(cfg.eps))
        if _decay_mask(name):
            delta.add_(p.float() * cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
        del delta
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
