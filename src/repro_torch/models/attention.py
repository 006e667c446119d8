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

Sharded (DTensor) inputs carry the reference's ``psharding.constrain``
hints on q, k, v and the output.  The attention itself (scores, softmax,
the flash loops) runs on each rank's blocks through ``local_map``
(:func:`_sharded_attention`), in the layout the reference picks: heads
split over ``model`` when they divide it (the kv heads too when they
divide, else each rank takes the kv heads its q heads read from k / v
gathered over ``model``), else the q rows split over ``model`` against
whole k / v (context parallelism, the reference's ``q_seq`` and
``q_chunks`` hints).  Decode runs on DTensor ops over the
``kv_seq``-split cache.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import psharding as psh
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
                    chunk_q: int = 1024, chunk_k: int = 1024,
                    q_offset: int = 0):
    """Chunked online-softmax attention for long sequences: an outer loop
    over q chunks, an inner loop over every kv chunk with block masking
    (the reference's two ``lax.scan``s).  Peak temp is [B, H, chunk_q,
    chunk_k] instead of [B, H, S, S].  ``q`` may be a run of rows of the
    sequence starting at ``q_offset`` (a rank's share of the q chunks)."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    nq, nk = s // chunk_q, sk // chunk_k
    assert s % chunk_q == 0 and sk % chunk_k == 0, (s, sk, chunk_q, chunk_k)
    qc = q.reshape(b, nq, chunk_q, hkv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nk, chunk_k, hkv, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, chunk_k, hkv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / float(np.sqrt(hd))
    rows = torch.arange(chunk_q, device=q.device)
    cols = torch.arange(chunk_k, device=q.device)
    outs = []
    for iq in range(nq):
        qi = qc[iq]                          # [b, hkv, g, cq, hd]
        q_pos = q_offset + iq * chunk_q + rows
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
    h = p.wq.shape[1]
    # the reference's layout: heads over `model` when they divide it,
    # else the q rows (context parallelism) against whole k / v
    aligned = h % psh.tp_size(x) == 0
    q_hint = (("batch", None, "heads", "head_dim") if aligned
              else ("batch", "q_seq", None, None))
    kv_hint = (("batch", None, "kv_heads", "head_dim") if aligned
               else ("batch", None, None, None))
    q = psh.constrain(psh.einsum("bsd,dhk->bshk", x, p.wq), *q_hint)
    if kv_override is None:
        k = psh.constrain(psh.einsum("bsd,dhk->bshk", x, p.wk), *kv_hint)
        v = psh.constrain(psh.einsum("bsd,dhk->bshk", x, p.wv), *kv_hint)
        if rope_theta:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
    else:
        k, v = kv_override
        if rope_theta:
            q = rope(q, positions, rope_theta)
    flash = s > flash_threshold and kv_override is None and k.shape[1] == s
    q_positions = positions[0] if positions.ndim > 1 else positions
    if isinstance(q, DTensor):
        o = _sharded_attention(q, k, v, causal=causal, window=window,
                               q_positions=q_positions, flash=flash,
                               aligned=aligned)
    elif flash:
        o = flash_attention(q, k, v, causal=causal, window=window)
    else:
        o = full_attention(q, k, v, causal=causal, window=window,
                           q_positions=q_positions)
    o = psh.constrain(o, *q_hint)
    return psh.einsum("bshk,hkd->bsd", o, p.wo)


def _sharded_attention(q, k, v, *, causal, window, q_positions, flash,
                       aligned):
    """Attention of DTensors q [B, Sq, H, hd], k / v [B, Sk, Hkv, hd] on
    each rank's blocks (``local_map``): the batch stays split as q's is;
    over ``model`` either q's heads split (``aligned``; k / v split by kv
    heads when those divide, else gathered over ``model``, the kv heads a
    rank's q heads read being picked locally) or q's rows split (k / v
    gathered).  No collective runs inside."""
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model")
    tp, r = mesh.size(mi), mesh.get_local_rank("model")
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q_dim = 2 if aligned else (1 if sq % tp == 0 else None)
    kv_dim = 2 if aligned and hkv % tp == 0 else None
    base = [p if i != mi else Replicate() for i, p in enumerate(q.placements)]

    def at_model(dim):
        out = list(base)
        out[mi] = Shard(dim) if dim is not None else Replicate()
        return tuple(out)

    q_pl, kv_pl = at_model(q_dim), at_model(kv_dim)

    def body(ql, kl, vl):
        off = 0
        if aligned and kv_dim is None:
            # k / v whole over `model`: take the kv heads of this rank's
            # q heads [r*hl, (r+1)*hl), kv head of q head j being j // g
            hl = h // tp
            if hl % g == 0:
                kl = kl[:, :, r * hl // g:(r + 1) * hl // g]
                vl = vl[:, :, r * hl // g:(r + 1) * hl // g]
            elif g % hl == 0:
                kl = kl[:, :, r * hl // g:r * hl // g + 1]
                vl = vl[:, :, r * hl // g:r * hl // g + 1]
            else:
                idx = (r * hl + torch.arange(hl, device=kl.device)) // g
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        elif q_dim == 1:
            off = r * (sq // tp)
        if flash:
            return flash_attention(ql, kl, vl, causal=causal, window=window,
                                   q_offset=off)
        return full_attention(ql, kl, vl, causal=causal, window=window,
                              q_positions=q_positions[off:off + ql.shape[1]])

    fn = psh.local_map(body, (q_pl,), (q_pl, kv_pl, kv_pl), mesh)
    return fn(q, k, v)


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
    q = psh.einsum("bsd,dhk->bshk", x, p.wq)
    k_new = psh.einsum("bsd,dhk->bshk", x, p.wk)
    v_new = psh.einsum("bsd,dhk->bshk", x, p.wv)
    posb = torch.full((b, 1), pos, device=x.device)
    if rope_theta:
        q = rope(q, posb, rope_theta)
        k_new = rope(k_new, posb, rope_theta)
    slot = pos % length if window else min(pos, length - 1)
    idx = torch.arange(length, device=x.device)
    if isinstance(cache["k"], DTensor):
        ck = _sharded_slot_write(cache["k"], k_new, slot)
        cv = _sharded_slot_write(cache["v"], v_new, slot)
    else:
        wmask = (idx == slot)[None, :, None, None]
        ck = torch.where(wmask, k_new.to(cache["k"].dtype), cache["k"])
        cv = torch.where(wmask, v_new.to(cache["v"].dtype), cache["v"])
    ck = psh.constrain(ck, "batch", "kv_seq", None, None)
    cv = psh.constrain(cv, "batch", "kv_seq", None, None)
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
    if isinstance(ck, DTensor):
        o = _sharded_decode_attention(q, ck, cv, valid)
        return psh.einsum("bshk,hkd->bsd", o, p.wo), {"k": ck, "v": cv}
    qg = q.reshape(b, 1, hkv, g, hd)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).float()
    sc = sc / float(np.sqrt(hd))
    sc = torch.where(valid[None, None, None, None, :], sc, NEG_INF)
    pattn = torch.softmax(sc, dim=-1).to(x.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pattn, cv).reshape(b, 1, h, hd)
    out = psh.einsum("bshk,hkd->bsd", o, p.wo)
    return out, {"k": ck, "v": cv}


def _sharded_slot_write(cache, new, slot: int):
    """``cache`` [B, L, Hkv, hd] (a DTensor, in its spec's layout) with
    ``new`` [B, 1, Hkv, hd] written at ``slot``, as the masked ``where``
    of the unsharded path, on each rank's block (``local_map``): a rank
    holding a run of the length writes if the slot falls in it.  The
    cache keeps its layout (left to choose, DTensor may move the whole
    cache to ``new``'s layout and back)."""
    mesh = cache.device_mesh
    c_pl = tuple(cache.placements)
    n_pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1 else q
                 for q in c_pl)
    splits = [i for i, q in enumerate(c_pl) if isinstance(q, Shard)
              and q.dim == 1]
    runs = math.prod(mesh.size(i) for i in splits)
    lo = 0
    for i in splits:                      # this rank's first slot
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= cache.shape[1] // runs

    def body(cl, nl):
        idx = lo + torch.arange(cl.shape[1], device=cl.device)
        return torch.where((idx == slot)[None, :, None, None],
                           nl.to(cl.dtype), cl)

    return psh.local_map(body, (c_pl,), (c_pl, n_pl), mesh)(cache, new)


def _sharded_decode_attention(q, ck, cv, valid):
    """One-token attention against a DTensor cache split by batch and by
    its length (``kv_seq``), the flash-decode combine: each rank scores
    its block of slots (``local_map``: q whole over the length's ranks,
    a split of kv heads or head_dim gathered) and keeps its running max,
    sum and weighted values; the blocks then merge by DTensor ops on
    those small [ranks, B, Hkv, g, 1(, hd)] pieces."""
    mesh = ck.device_mesh
    b, _, h, hd = q.shape
    hkv = ck.shape[2]
    kv_pl = tuple(r if isinstance(r, Shard) and r.dim in (0, 1)
                  else Replicate() for r in ck.placements)
    q_pl = tuple(r if isinstance(r, Shard) and r.dim == 0 else Replicate()
                 for r in kv_pl)
    # per-rank pieces: a leading dim split over the length's ranks
    piece_pl = tuple(Shard(0) if isinstance(r, Shard) and r.dim == 1 else
                     (Shard(1) if isinstance(r, Shard) else Replicate())
                     for r in kv_pl)
    ck_in = ck.redistribute(mesh, kv_pl) if ck.placements != kv_pl else ck
    valid = psh.shard_like(valid, ck_in, {1: 0})

    def body(ql, kl, vl, ok):
        qg = ql.reshape(ql.shape[0], 1, hkv, h // hkv, hd)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl).float()
        sc = sc / float(np.sqrt(hd))
        sc = torch.where(ok[None, None, None, None, :], sc, NEG_INF)
        m = sc.amax(-1)
        e = torch.exp(sc - m[..., None])
        acc = torch.einsum("bhgqk,bkhd->bhgqd", e.to(ql.dtype), vl).float()
        return m[None], e.sum(-1)[None], acc[None]

    m, l, acc = psh.local_map(body, (piece_pl,) * 3,
                              (q_pl, kv_pl, kv_pl, tuple(
                                  Shard(0) if isinstance(r, Shard)
                                  and r.dim == 1 else Replicate()
                                  for r in kv_pl)), mesh)(q, ck_in, cv,
                                                          valid)
    w = torch.exp(m - torch.amax(m, dim=0))
    o = torch.sum(acc * w[..., None], dim=0) / torch.sum(l * w, dim=0)[
        ..., None]                                    # [B, Hkv, g, 1, hd]
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)
