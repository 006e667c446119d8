"""Shared layer primitives: norms, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

Every cast point is the reference's: norms and activations compute in
float32 and return the input dtype, and a product of two tensors keeps
their dtype.  Where JAX promotes a mixed product (bf16 with float32) the
port casts explicitly, since ``torch.einsum`` refuses mixed dtypes.
``jax.nn.gelu`` defaults to the tanh approximation, so the port's gelu
is ``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def new_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``reset_parameters`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """Fill ``p`` with N(0, 1) * ``scale`` drawn in float32 from
    ``generator`` (which lives on ``p``'s device)."""
    p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32) * scale)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., seq, heads, head_dim]; positions [..., seq]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., :, None].float() * freq          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def sinusoidal(seq: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """:func:`sinusoidal_positions` on ``like``'s device, in its dtype."""
    return torch.from_numpy(sinusoidal_positions(seq, d)).to(
        device=like.device, dtype=like.dtype)


class MLP(nn.Module):
    """The reference's ``mlp_params``: ``w_up`` [d, f], ``w_down`` [f, d]
    and, for swiglu, ``w_gate`` [d, f]."""

    def __init__(self, d: int, f: int, act: str, dtype, device=None):
        super().__init__()
        self.act = act
        if act == "swiglu":
            self.w_gate = new_param((d, f), dtype, device)
        self.w_up = new_param((d, f), dtype, device)
        self.w_down = new_param((f, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_up.shape
        if self.act == "swiglu":
            normal_(self.w_gate, generator, 1.0 / float(np.sqrt(d)))
        normal_(self.w_up, generator, 1.0 / float(np.sqrt(d)))
        normal_(self.w_down, generator, 1.0 / float(np.sqrt(f)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(x, self, self.act)


def mlp_forward(x: torch.Tensor, p: MLP, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = torch.einsum("...d,df->...f", x, p.w_gate)
        u = torch.einsum("...d,df->...f", x, p.w_up)
        h = F.silu(g.float()).to(x.dtype) * u
    else:  # gelu
        h = torch.einsum("...d,df->...f", x, p.w_up)
        h = gelu(h.float()).to(x.dtype)
    return torch.einsum("...f,fd->...d", h, p.w_down)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       valid_vocab: int | None = None) -> torch.Tensor:
    """NLL over (possibly vocab-padded) logits; padded columns masked."""
    logits = logits.float()
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
