"""Mixture-of-Experts MLP: top-k routing, three dispatch engines (port of
``repro.models.moe``).

* ``gather`` (default) — sort-based capacity-FIFO dispatch: (token, slot)
  pairs are sorted by expert (a stable sort, as ``jnp.argsort``), ranked
  within their expert queue, and moved with an index write into an
  ``e*cap + 1``-row buffer whose last row takes every overflowed pair and
  is dropped (the reference's ``.at[slot].set(mode="drop")``), and an
  ``index_add`` back to the tokens.
* ``onehot`` — the GShard baseline: a dense [c, k, e, cap] one-hot
  dispatch einsum.
* ``ep`` — expert parallelism under an ambient mesh
  (``launch.mesh.use_mesh``) whose ``model`` axis has more than one rank:
  each rank holds its own block of experts, routes every token of its
  data shard, runs its block, and one all-reduce (SUM) over the
  ``model`` group combines the partial outputs, as the reference's
  ``psum`` does.  Without such a mesh it falls back to ``gather`` (with
  every expert's weights).

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (a stable descending sort).  Tokens are cut into chunks of
``chunk`` (the last padded with zero rows, which are routed and take
capacity, as in the reference); overflowed pairs fall through the
residual.  Capacity is ``max(int(chunk * top_k / e * capacity_factor),
4)`` a chunk.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import axes_group, axis_size, get_abstract_mesh
from repro_torch.models.layers import new_param, normal_


class MoE(nn.Module):
    """The reference's ``moe_params``: ``router`` [d, e] (float32) and the
    stacked experts ``w_gate`` / ``w_up`` [e, d, f], ``w_down`` [e, f, d]."""

    def __init__(self, d: int, f: int, e: int, dtype, device=None):
        super().__init__()
        self.router = new_param((d, e), torch.float32, device)
        self.w_gate = new_param((e, d, f), dtype, device)
        self.w_up = new_param((e, d, f), dtype, device)
        self.w_down = new_param((e, f, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        e, d, f = self.w_gate.shape
        s_in = 1.0 / float(np.sqrt(d))
        normal_(self.router, generator, s_in)
        normal_(self.w_gate, generator, s_in)
        normal_(self.w_up, generator, s_in)
        normal_(self.w_down, generator, 1.0 / float(np.sqrt(f)))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(probs, k):
    gate_vals, gate_idx = top_k(probs, k)                    # [c, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, gate_idx


def _queues(gate_idx, e):
    """Sort the (token, slot) pairs by expert; each pair's rank in its
    expert's queue.  Returns (order, sorted_e, sorted_tok, rank)."""
    k = gate_idx.shape[-1]
    flat_e = gate_idx.reshape(-1)                            # [c*k]
    sorted_e, order = torch.sort(flat_e, stable=True)
    sorted_tok = order // k
    # rank within each expert's queue; searchsorted = queue head offsets
    start = torch.searchsorted(
        sorted_e, torch.arange(e, device=gate_idx.device), side="left")
    rank = torch.arange(flat_e.numel(), device=gate_idx.device) \
        - start[sorted_e]
    return order, sorted_e, sorted_tok, rank


def _expert_ffn(xe, wg, wu, wd, dtype):
    """xe: [e, cap, d] -> [e, cap, d] (stacked-expert swiglu)."""
    g = F.silu(torch.einsum("eod,edf->eof", xe, wg).float())
    u = torch.einsum("eod,edf->eof", xe, wu).float()
    return torch.einsum("eof,efd->eod", (g * u).to(dtype), wd)


def _chunk_onehot(xi, probs, p: MoE, *, top_k, e, cap, chunk):
    gate_vals, gate_idx = _gates(probs, top_k)
    onehot = F.one_hot(gate_idx, e).float()                  # [c, k, e]
    # position of each (token, slot) within its expert queue
    pos = torch.cumsum(onehot.reshape(-1, e), dim=0).reshape(
        chunk, top_k, e) * onehot - 1.0
    fits = (pos >= 0) & (pos < cap)
    # jax.nn.one_hot of an index == cap is a zero row: one class more,
    # then cut
    disp = F.one_hot(torch.where(fits, pos, float(cap)).long(),
                     cap + 1)[..., :cap].float() * fits[..., None]
    # dispatch: [c,k,e,cap] x [c,d] -> [e, cap, d]
    xe = torch.einsum("ckeo,cd->eod", disp, xi.float()).to(xi.dtype)
    ye = _expert_ffn(xe, p.w_gate, p.w_up, p.w_down, xi.dtype)
    comb = torch.einsum("ckeo,ck->ckeo", disp, gate_vals.float())
    yi = torch.einsum("ckeo,eod->cd", comb, ye.float())
    return yi.to(xi.dtype)


def _dispatch_local(xi, probs, wg, wu, wd, *, top_k, e, lo, el, cap):
    """Sort-FIFO dispatch through the experts [lo, lo + el): queue ranks
    over the full expert id space, so the capacity-drop set is the
    single-engine one; only those experts' slots are materialised."""
    gate_vals, gate_idx = _gates(probs, top_k)
    order, sorted_e, sorted_tok, rank = _queues(gate_idx, e)
    local_e = sorted_e - lo
    mine = (local_e >= 0) & (local_e < el) & (rank < cap)
    slot = torch.where(mine, local_e * cap + rank, el * cap)
    # dispatch: write token rows into the [el*cap, d] expert buffers; the
    # extra last row takes every pair that is not dispatched
    xe = torch.zeros((el * cap + 1, xi.shape[1]), dtype=xi.dtype,
                     device=xi.device)
    xe = xe.index_put((slot,), xi[sorted_tok])[:-1]
    ye = _expert_ffn(xe.reshape(el, cap, -1), wg, wu, wd, xi.dtype)
    # combine: gather each surviving slot's output back to its token
    contrib = ye.reshape(el * cap, -1)[torch.clamp(slot, max=el * cap - 1)]
    w = torch.where(mine, gate_vals.reshape(-1)[order], 0.0)
    yi = torch.zeros_like(xi)
    return yi.index_add(0, sorted_tok, contrib * w[:, None].to(contrib.dtype))


def _chunk_gather(xi, probs, p: MoE, *, top_k, e, cap, chunk):
    """Sort-based FIFO dispatch (the BFS queue-crossbar mechanism)."""
    return _dispatch_local(xi, probs, p.w_gate, p.w_up, p.w_down,
                           top_k=top_k, e=e, lo=0, el=e, cap=cap)


def _chunks(x, router, chunk, top_k, capacity_factor):
    """Tokens in chunks (the last zero-padded), their router
    probabilities and logits, the chunk size and the capacity."""
    b, s, d = x.shape
    e = router.shape[1]
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xc = xt.reshape(-1, chunk, d)
    cap = max(int(chunk * top_k / e * capacity_factor), 4)
    logits_all = torch.einsum("ntd,de->nte", xc.float(), router)
    return xc, torch.softmax(logits_all, dim=-1), logits_all, chunk, cap


def _switch_aux(probs_all, logits_all, e, group=None, size=1):
    """Load-balancing aux loss (Switch): E * sum_e f_e * P_e, the
    fractions averaged over ``group`` (``size`` ranks) before their
    product."""
    me = probs_all.mean((0, 1))
    top1 = F.one_hot(torch.argmax(logits_all, -1), e).float().mean((0, 1))
    if group is not None:
        me = dist_fn.all_reduce(me, group=group) / size
        top1 = dist_fn.all_reduce(top1, group=group) / size
    return e * torch.sum(me * top1)


def routing(x: torch.Tensor, p: MoE, *, top_k: int,
            capacity_factor: float = 1.25, chunk: int = 1024):
    """The router's choices for ``x`` [B, S, d], as ``moe_forward`` makes
    them: (gate_idx int64[T, k], kept bool[T, k]) over the T tokens
    including the last chunk's pad rows; ``kept`` is False where the
    pair overflowed its expert's capacity."""
    e = p.router.shape[1]
    xc, probs_all, _, _, cap = _chunks(x, p.router, chunk, top_k,
                                       capacity_factor)
    idx, kept = [], []
    for probs in probs_all:
        _, gate_idx = _gates(probs, top_k)
        order, _, _, rank = _queues(gate_idx, e)
        fits = torch.empty_like(rank, dtype=torch.bool)
        fits[order] = rank < cap
        idx.append(gate_idx)
        kept.append(fits.reshape(gate_idx.shape))
    return torch.cat(idx), torch.cat(kept)


def _moe_forward_ep(x: torch.Tensor, p: MoE, mesh, *, top_k: int,
                    capacity_factor: float, chunk: int):
    """Expert parallelism, as the reference's ``shard_map`` body: ``x`` is
    this rank's data shard (replicated over ``model``) and ``p``'s
    experts are this rank's block, experts [r*el, (r+1)*el) of the
    router's ``e``, where r is its ``model`` index and el = e / |model|.
    One all-reduce over the ``model`` group sums the partial outputs."""
    names = mesh.mesh_dim_names
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    b, s, d = x.shape
    e = p.router.shape[1]
    el = e // axis_size(mesh, "model")
    r = mesh.get_local_rank("model")
    if p.w_gate.shape[0] != el:
        raise ValueError(f"expert parallelism over {e // el} ranks takes "
                         f"this rank's {el} experts, not "
                         f"{p.w_gate.shape[0]}")
    xc, probs_all, logits_all, c, cap = _chunks(x, p.router, chunk, top_k,
                                                capacity_factor)
    yc = torch.stack([
        _dispatch_local(xi, probs, p.w_gate, p.w_up, p.w_down, top_k=top_k,
                        e=e, lo=r * el, el=el, cap=cap)
        for xi, probs in zip(xc, probs_all)])
    y = yc.reshape(-1, d)[: b * s].reshape(b, s, d)
    y = dist_fn.all_reduce(y, group=axes_group(mesh, "model"))
    # the Switch loss is nonlinear in the partition: average the
    # per-expert fractions over the data ranks BEFORE taking the product
    group = axes_group(mesh, dp_axes) if dp_axes else None
    aux = _switch_aux(probs_all, logits_all, e, group,
                      axis_size(mesh, dp_axes) if dp_axes else 1)
    return y, aux


def _ep_applicable(mesh, e) -> bool:
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return False
    tp = axis_size(mesh, "model")
    return tp > 1 and e % tp == 0


def moe_forward(x: torch.Tensor, p: MoE, *, top_k: int,
                capacity_factor: float = 1.25, chunk: int = 1024,
                dispatch: str = "gather"):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    if dispatch == "ep":
        mesh = get_abstract_mesh()
        if _ep_applicable(mesh, p.router.shape[1]):
            return _moe_forward_ep(x, p, mesh, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   chunk=chunk)
        dispatch = "gather"   # single-device / misaligned fallback
    b, s, d = x.shape
    e = p.router.shape[1]
    xc, probs_all, logits_all, chunk, cap = _chunks(
        x, p.router, chunk, top_k, capacity_factor)
    chunk_fn = _chunk_gather if dispatch == "gather" else _chunk_onehot
    yc = torch.stack([chunk_fn(xi, probs, p, top_k=top_k, e=e, cap=cap,
                               chunk=chunk)
                      for xi, probs in zip(xc, probs_all)])
    y = yc.reshape(-1, d)[: b * s].reshape(b, s, d)
    return y, _switch_aux(probs_all, logits_all, e)
