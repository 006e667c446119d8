"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (port of
``repro.models.ssm``).

Scalar-identity state transition per head: h_t = a_t * h_{t-1} + dt_t * B_t x_t,
y_t = C_t h_t + D x_t, with a_t = exp(-dt_t * exp(A_log)).  Training uses the
SSD chunked decomposition (quadratic only within a 256-position chunk, the
sequence zero-padded to whole chunks, an O(hd*N) state carried across
chunks); decode is the single-step recurrence over a cached state, the
conv history of the x/B/C streams in the cache beside it.

Shapes: d_inner = expand * d_model, heads = d_inner / head_dim,
state = ssm_state (N).  One weight per input stream (w_z / w_xin / w_b /
w_c / w_dt), as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import psharding as psh
from repro_torch.models.layers import new_param, normal_


class SSM(nn.Module):
    """The reference's ``ssm_params``."""

    def __init__(self, d: int, expand: int, head_dim: int, state: int,
                 conv_width: int, dtype, device=None):
        super().__init__()
        di = expand * d
        nh = di // head_dim
        self.w_z = new_param((d, di), dtype, device)
        self.w_xin = new_param((d, di), dtype, device)
        self.w_b = new_param((d, state), dtype, device)
        self.w_c = new_param((d, state), dtype, device)
        self.w_dt = new_param((d, nh), dtype, device)
        self.conv_wx = new_param((conv_width, di), dtype, device)
        self.conv_bx = new_param((di,), dtype, device)
        self.conv_wb = new_param((conv_width, state), dtype, device)
        self.conv_bb = new_param((state,), dtype, device)
        self.conv_wc = new_param((conv_width, state), dtype, device)
        self.conv_bc = new_param((state,), dtype, device)
        self.a_log = new_param((nh,), torch.float32, device)
        self.d_skip = new_param((nh,), torch.float32, device)
        self.dt_bias = new_param((nh,), torch.float32, device)
        self.out_proj = new_param((di, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d, di = self.w_z.shape
        nh = self.a_log.shape[0]
        s = 1.0 / float(np.sqrt(d))
        for w in (self.w_z, self.w_xin, self.w_b, self.w_c, self.w_dt):
            normal_(w, generator, s)
        for w, b in ((self.conv_wx, self.conv_bx), (self.conv_wb,
                     self.conv_bb), (self.conv_wc, self.conv_bc)):
            normal_(w, generator, 0.5)
            b.zero_()
        # the reference's fixed numpy draws, the same for every layer
        self.a_log.copy_(torch.from_numpy(np.asarray(
            np.log(np.random.default_rng(0).uniform(1, 16, nh)),
            np.float32)))
        self.d_skip.fill_(1.0)
        self.dt_bias.copy_(torch.from_numpy(np.asarray(
            np.log(np.expm1(np.random.default_rng(1).uniform(1e-3, 0.1,
                                                             nh))),
            np.float32)))
        normal_(self.out_proj, generator, 1.0 / float(np.sqrt(di)))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU.  u: [B, S, C]; w: [K, C]."""
    if isinstance(u, DTensor):
        return psh.along_seq(_causal_conv, (u,), (w, b))
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[:, i: i + u.shape[1], :] * w[i] for i in range(k))
    return F.silu((out + b).float()).to(u.dtype)


def ssm_forward(x_in: torch.Tensor, p: SSM, *, expand: int, head_dim: int,
                state: int, chunk: int = 256) -> torch.Tensor:
    """x_in: [B, S, d] -> [B, S, d] (training / prefill path), the SSD
    chunked decomposition [arXiv:2405.21060 §6]: within a chunk the
    recurrence is evaluated in its "attention" dual form (an L x L masked
    score matrix per head); across chunks only the [nh, hd, N]
    end-of-chunk state is carried.  On DTensors the projections carry the
    reference's hints and the scan runs on each rank's heads
    (:func:`_ssd_scan` through ``local_map``)."""
    b, s, d = x_in.shape
    di = expand * d
    nh = di // head_dim
    z = psh.constrain(psh.einsum("bsd,dp->bsp", x_in, p.w_z),
                      "batch", None, "ff")
    xs = psh.constrain(psh.einsum("bsd,dp->bsp", x_in, p.w_xin),
                       "batch", None, "ff")
    bm = psh.einsum("bsd,dn->bsn", x_in, p.w_b)
    cm = psh.einsum("bsd,dn->bsn", x_in, p.w_c)
    dt = psh.constrain(psh.einsum("bsd,dh->bsh", x_in, p.w_dt),
                       "batch", None, "heads")
    xs = _causal_conv(xs, p.conv_wx, p.conv_bx)
    bm = _causal_conv(bm, p.conv_wb, p.conv_bb)
    cm = _causal_conv(cm, p.conv_wc, p.conv_bc)
    dt = psh.pointwise(F.softplus, dt.float() + p.dt_bias)   # [B,S,nh]
    la = -dt * torch.exp(p.a_log)                            # log a_t <= 0
    xh = psh.constrain(xs.reshape(b, s, nh, head_dim),
                       "batch", None, "heads", None)
    if isinstance(xh, DTensor):
        mesh = xh.device_mesh
        heads = tuple(xh.placements)             # batch split, heads split
        per_head = tuple(Shard(2) if isinstance(q, Shard) and q.dim == 2
                         else q for q in heads)  # [B, S, nh] as xh's heads
        shared = tuple(q if isinstance(q, Shard) and q.dim == 0
                       else Replicate() for q in heads)   # B / C streams
        skip = tuple(Shard(0) if isinstance(q, Shard) and q.dim == 2
                     else Replicate() for q in heads)     # [nh]
        y = psh.local_map(
            functools.partial(_ssd_scan, chunk=chunk), (heads,),
            (per_head, per_head, heads, shared, shared, skip), mesh)(
                dt, la, xh, bm, cm, p.d_skip)
    else:
        y = _ssd_scan(dt, la, xh, bm, cm, p.d_skip, chunk=chunk)
    y = y.reshape(b, s, di).to(x_in.dtype)
    y = y * F.silu(z.float()).to(x_in.dtype)
    return psh.einsum("bsi,id->bsd", y, p.out_proj)


def _ssd_scan(dt, la, xh, bm, cm, d_skip, *, chunk: int) -> torch.Tensor:
    """The SSD scan: dt, la [B, S, nh] float32, xh [B, S, nh, hd], bm /
    cm [B, S, N] -> y [B, S, nh, hd] float32 (with the D skip).  Heads
    are independent, so a rank runs it on its own heads."""
    b, s, nh, head_dim = xh.shape
    state = bm.shape[-1]
    xh32 = xh.float()
    dtx = dt[..., None] * xh32                               # [B,S,nh,hd]
    pad = (-s) % chunk
    bm32, cm32 = bm.float(), cm.float()
    if pad:
        la = F.pad(la, (0, 0, 0, pad))
        dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
        bm32 = F.pad(bm32, (0, 0, 0, pad))
        cm32 = F.pad(cm32, (0, 0, 0, pad))
    c = chunk
    nc = la.shape[1] // c
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))
    h = torch.zeros((b, nh, head_dim, state), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        lai, dtxi, bi, ci = la[:, sl], dtx[:, sl], bm32[:, sl], cm32[:, sl]
        cum = torch.cumsum(lai, dim=1)                       # inclusive
        # y_diag[t] = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dtx_s
        scores = torch.einsum("btn,bsn->bts", ci, bi)        # [B,c,c]
        dec = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        w = scores[..., None] * torch.where(tril[None, :, :, None], dec, 0.0)
        y_diag = torch.einsum("btsh,bshd->bthd", w, dtxi)
        # y_off[t] = exp(cum_t) * (C_t . h_prev)
        y_off = torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhdn->bthd", ci, h)
        # end-of-chunk state: exp(cum_last) h_prev + decayed outer products
        sdec = torch.exp(cum[:, -1:, :] - cum)               # [B,c,nh]
        s_c = torch.einsum("bsh,bshd,bsn->bhdn", sdec, dtxi, bi)
        h = torch.exp(cum[:, -1])[..., None, None] * h + s_c
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)[:, :s]
    return y + xh32 * d_skip[:, None]


def ssm_init_cache(batch: int, d: int, expand: int, head_dim: int,
                   state: int, conv_width: int, dtype, device=None) -> dict:
    di = expand * d
    nh = di // head_dim

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "conv_x": z(batch, conv_width - 1, di),
        "conv_b": z(batch, conv_width - 1, state),
        "conv_c": z(batch, conv_width - 1, state),
        "h": z(batch, nh, head_dim, state, dt=torch.float32),
    }


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One-token depthwise conv against a [B, K-1, C] history window."""
    window = torch.cat([hist, new[:, None]], dim=1)
    out = psh.einsum("bkc,kc->bc", window, w) + b
    return F.silu(out.float()).to(new.dtype), window[:, 1:]


def _state_step(h, a, dt, bm, xh, cm):
    """One step of the recurrence: the new state [B, nh, hd, N] and its
    read-out C . h [B, nh, hd]."""
    h = h * a[..., None, None] + torch.einsum("bh,bn,bhd->bhdn", dt, bm, xh)
    return h, torch.einsum("bhdn,bn->bhd", h, cm)


def _sharded_state_step(h, a, dt, bm, xh, cm):
    """:func:`_state_step` on each rank's block of the state DTensor ``h``
    as its cache spec splits it (``local_map``): the other inputs are cut
    to match, and where the state dim N is split the read-out is a
    partial sum over those ranks."""
    mesh = h.device_mesh
    # h's dims -> the matching dim of each other input (None: unsplit)
    dims = {"a": {0: 0, 1: 1}, "bn": {0: 0, 3: 1}, "x": {0: 0, 1: 1, 2: 2}}
    hp = tuple(h.placements)

    def cut(which, partial=False):
        out = []
        for q in hp:
            d = q.dim if isinstance(q, Shard) else None
            if d in dims[which]:
                out.append(Shard(dims[which][d]))
            else:
                out.append(Partial() if partial and d == 3 else Replicate())
        return tuple(out)

    a_pl, bn_pl, x_pl = cut("a"), cut("bn"), cut("x")
    return psh.local_map(_state_step, (hp, cut("x", partial=True)),
                         (hp, a_pl, a_pl, bn_pl, x_pl, bn_pl), mesh)(
                             h, a, dt, bm, xh, cm)


def ssm_decode(x_in: torch.Tensor, p: SSM, cache: dict, *, expand: int,
               head_dim: int, state: int):
    """One-token decode.  x_in: [B, 1, d]."""
    b, _, d = x_in.shape
    di = expand * d
    nh = di // head_dim
    x0 = x_in[:, 0]
    z = psh.einsum("bd,dp->bp", x0, p.w_z)
    xs = psh.einsum("bd,dp->bp", x0, p.w_xin)
    bm = psh.einsum("bd,dn->bn", x0, p.w_b)
    cm = psh.einsum("bd,dn->bn", x0, p.w_c)
    dt = psh.einsum("bd,dh->bh", x0, p.w_dt)
    xs, conv_x = _conv_step(cache["conv_x"], xs, p.conv_wx, p.conv_bx)
    bm, conv_b = _conv_step(cache["conv_b"], bm, p.conv_wb, p.conv_bb)
    cm, conv_c = _conv_step(cache["conv_c"], cm, p.conv_wc, p.conv_bc)
    dt = psh.pointwise(F.softplus, dt.float() + p.dt_bias)
    a = torch.exp(-dt * torch.exp(p.a_log))                  # [B, nh]
    xh = xs.reshape(b, nh, head_dim).float()
    if isinstance(cache["h"], DTensor):
        h, y = _sharded_state_step(cache["h"], a, dt, bm.float(), xh,
                                   cm.float())
    else:
        h, y = _state_step(cache["h"], a, dt, bm.float(), xh, cm.float())
    y = y + xh * p.d_skip[:, None]
    y = y.reshape(b, di).to(x_in.dtype)
    y = y * F.silu(z.float()).to(x_in.dtype)
    out = psh.einsum("bi,id->bd", y, p.out_proj)[:, None]
    new_cache = {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                 "h": h}
    return out, new_cache
