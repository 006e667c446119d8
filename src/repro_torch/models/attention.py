"""GQA attention: full, sliding-window, chunked (flash-style), and decode
(port of ``repro.models.attention``).

GQA is computed with grouped einsums (q reshaped to [B, S, hkv, groups,
hd]), never a repeat of K/V.  Masked scores are ``NEG_INF = -1e30``, not
``-inf``: a row masked everywhere (a ring slot not yet written) gets
uniform weights instead of NaN, as in the reference.  Scores and softmax
are float32; every einsum keeps its inputs' dtype.  The chunked flash
path is the reference's pure online-softmax loop (1024-row chunks), used
only above ``flash_threshold``; it is not the K7 kernel, which the
reference's LM path never calls.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import new_param, normal_, rope

NEG_INF = -1e30


class Attention(nn.Module):
    """The reference's ``attn_params``: ``wq`` [d, h, hd], ``wk`` / ``wv``
    [d, hkv, hd], ``wo`` [h, hd, d]."""

    def __init__(self, d: int, h: int, hkv: int, hd: int, dtype,
                 device=None):
        super().__init__()
        self.wq = new_param((d, h, hd), dtype, device)
        self.wk = new_param((d, hkv, hd), dtype, device)
        self.wv = new_param((d, hkv, hd), dtype, device)
        self.wo = new_param((h, hd, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, h, hd = self.wq.shape
        s = 1.0 / float(np.sqrt(d))
        for w in (self.wq, self.wk, self.wv):
            normal_(w, generator, s)
        normal_(self.wo, generator, 1.0 / float(np.sqrt(h * hd)))


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_positions=None, k_positions=None):
    """Masked full attention.  q: [B,Sq,H,hd]; k/v: [B,Sk,Hkv,hd]."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / float(np.sqrt(hd))
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device)
    if k_positions is None:
        k_positions = torch.arange(k.shape[1], device=q.device)
    qp = q_positions[:, None]
    kp = k_positions[None, :]
    mask = (torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
            if not causal else kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, sq, h, hd)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    chunk_q: int = 1024, chunk_k: int = 1024):
    """Chunked online-softmax attention for long sequences: an outer loop
    over q chunks, an inner loop over every kv chunk with block masking
    (the reference's two ``lax.scan``s).  Peak temp is [B, H, chunk_q,
    chunk_k] instead of [B, H, S, S]."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    nq, nk = s // chunk_q, s // chunk_k
    assert s % chunk_q == 0 and s % chunk_k == 0, (s, chunk_q, chunk_k)
    qc = q.reshape(b, nq, chunk_q, hkv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nk, chunk_k, hkv, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, chunk_k, hkv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / float(np.sqrt(hd))
    rows = torch.arange(chunk_q, device=q.device)
    cols = torch.arange(chunk_k, device=q.device)
    outs = []
    for iq in range(nq):
        qi = qc[iq]                          # [b, hkv, g, cq, hd]
        q_pos = iq * chunk_q + rows
        m = torch.full((b, hkv, g, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, chunk_q, hd), dtype=torch.float32,
                          device=q.device)
        for jk in range(nk):
            kj, vj = kc[jk], vc[jk]          # [b, hkv, ck, hd]
            k_pos = jk * chunk_k + cols
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj).float() * scale
            mask = torch.ones((chunk_q, chunk_k), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            sc = torch.where(mask[None, None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(qi.dtype), vj).float()
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs)                  # [nq, b, hkv, g, cq, hd]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, hd)


def attention_block(x, p: Attention, *, positions, causal=True, window=0,
                    rope_theta=500000.0, flash_threshold=8192,
                    kv_override=None):
    """Projection + RoPE + attention + output projection.

    kv_override: (k, v) for cross-attention (already projected+roped).
    """
    b, s, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, p.wk)
        v = torch.einsum("bsd,dhk->bshk", x, p.wv)
        if rope_theta:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
    else:
        k, v = kv_override
        if rope_theta:
            q = rope(q, positions, rope_theta)
    if s > flash_threshold and kv_override is None and k.shape[1] == s:
        o = flash_attention(q, k, v, causal=causal, window=window)
    else:
        o = full_attention(q, k, v, causal=causal, window=window,
                           q_positions=positions[0] if positions.ndim > 1
                           else positions)
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def attention_decode(x, p: Attention, cache: dict, pos: int, *, window=0,
                     rope_theta=500000.0):
    """One-token decode.  x: [B, 1, d]; cache k/v: [B, L, Hkv, hd]; pos a
    Python int.

    For windowed layers the cache is a ring buffer of length `window`
    (slot = pos % window); for global layers it is the full sequence
    (slot = min(pos, L - 1)).  The write is a masked ``where`` over the
    cache, as in the reference.  Returns (out [B,1,d], new_cache)."""
    b = x.shape[0]
    length = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k_new = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v_new = torch.einsum("bsd,dhk->bshk", x, p.wv)
    posb = torch.full((b, 1), pos, device=x.device)
    if rope_theta:
        q = rope(q, posb, rope_theta)
        k_new = rope(k_new, posb, rope_theta)
    slot = pos % length if window else min(pos, length - 1)
    idx = torch.arange(length, device=x.device)
    wmask = (idx == slot)[None, :, None, None]
    ck = torch.where(wmask, k_new.to(cache["k"].dtype), cache["k"])
    cv = torch.where(wmask, v_new.to(cache["v"].dtype), cache["v"])
    # slot validity: ring slots hold positions pos-window+1..pos; full cache
    # slots 0..pos.
    if window:
        cycle = (pos // length) * length
        slot_pos = torch.where(idx <= slot, cycle + idx, cycle - length + idx)
        valid = (slot_pos >= 0) & (slot_pos <= pos)
    else:
        valid = idx <= pos
    h = q.shape[2]
    hkv = ck.shape[2]
    g = h // hkv
    hd = q.shape[-1]
    qg = q.reshape(b, 1, hkv, g, hd)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).float()
    sc = sc / float(np.sqrt(hd))
    sc = torch.where(valid[None, None, None, None, :], sc, NEG_INF)
    pattn = torch.softmax(sc, dim=-1).to(x.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pattn, cv).reshape(b, 1, h, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p.wo)
    return out, {"k": ck, "v": cv}
