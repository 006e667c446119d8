"""Griffin RG-LRU recurrent block [arXiv:2402.19427] (recurrentgemma;
port of ``repro.models.rglru``).

Block = (temporal conv1d width 4) -> RG-LRU gated linear recurrence:

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = a^(c * r_t)   with  a = sigmoid(Lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin recurrent-branch structure: linear in, GeLU (tanh)
gate branch, linear out.  Training runs the recurrence as a log-depth
(Hillis-Steele) scan, the reference as ``lax.associative_scan``: both
combine the same float32 terms in another order.  Decode carries
(conv window, h) in the cache.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import gelu, new_param, normal_

_C = 8.0


class RGLRU(nn.Module):
    """The reference's ``rglru_params``."""

    def __init__(self, d: int, width: int, conv_width: int, dtype,
                 device=None):
        super().__init__()
        self.w_x = new_param((d, width), dtype, device)
        self.w_gate_branch = new_param((d, width), dtype, device)
        self.conv_w = new_param((conv_width, width), dtype, device)
        self.conv_b = new_param((width,), dtype, device)
        self.w_r = new_param((width, width), dtype, device)
        self.w_i = new_param((width, width), dtype, device)
        self.lam = new_param((width,), torch.float32, device)
        self.w_out = new_param((width, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d, width = self.w_x.shape
        s = 1.0 / float(np.sqrt(d))
        sw = 1.0 / float(np.sqrt(width))
        normal_(self.w_x, generator, s)
        normal_(self.w_gate_branch, generator, s)
        normal_(self.conv_w, generator, 0.5)
        self.conv_b.zero_()
        normal_(self.w_r, generator, sw)
        normal_(self.w_i, generator, sw)
        # the reference's fixed numpy draw, the same for every layer
        self.lam.copy_(torch.from_numpy(np.asarray(
            np.random.default_rng(2).uniform(2.0, 5.0, width), np.float32)))
        normal_(self.w_out, generator, sw)


def _conv(u, w, b):
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    return sum(up[:, i: i + u.shape[1], :] * w[i] for i in range(k)) + b


def _gates(x, p: RGLRU):
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", x, p.w_r).float())
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", x, p.w_i).float())
    log_a = -_C * r * F.softplus(-p.lam)   # log(sigmoid(lam)^(c r))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log2(S)
    steps (Hillis-Steele): each step composes every prefix with the one
    ``step`` positions before it, (a, b) after (a', b') being
    (a' a, b' a + b)."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev = F.pad(a, (0, 0, step, 0), value=1.0)[:, :s]
        b_prev = F.pad(b, (0, 0, step, 0))[:, :s]
        a, b = a_prev * a, b_prev * a + b
        step *= 2
    return b


def rglru_forward(x_in: torch.Tensor, p: RGLRU) -> torch.Tensor:
    """x_in: [B, S, d] -> [B, S, d]."""
    x = torch.einsum("bsd,dw->bsw", x_in, p.w_x)
    gate = gelu(torch.einsum("bsd,dw->bsw", x_in, p.w_gate_branch).float())
    x = _conv(x, p.conv_w, p.conv_b)
    a, gated = _gates(x, p)
    h = linear_scan(a, gated)
    y = (h * gate).to(x_in.dtype)
    return torch.einsum("bsw,wd->bsd", y, p.w_out)


def rglru_init_cache(batch: int, width: int, conv_width: int, dtype,
                     device=None) -> dict:
    return {"conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device)}


def rglru_decode(x_in: torch.Tensor, p: RGLRU, cache: dict):
    """x_in: [B, 1, d]."""
    x = torch.einsum("bsd,dw->bsw", x_in, p.w_x)[:, 0]
    gate = gelu(torch.einsum("bsd,dw->bsw", x_in, p.w_gate_branch)
                .float())[:, 0]
    hist = torch.cat([cache["conv"], x[:, None]], dim=1)
    x = torch.einsum("bkw,kw->bw", hist, p.conv_w) + p.conv_b
    a, gated = _gates(x[:, None], p)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    y = (h * gate).to(x_in.dtype)
    out = torch.einsum("bw,wd->bd", y, p.w_out)[:, None]
    return out, {"conv": hist[:, 1:], "h": h}
