"""Plain PyTorch versions of the CUDA kernels (port of the oracles of
``repro.kernels.ref``).

They are what a kernel wrapper runs for a tensor on the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  Plane words
are int32 with the bits of the reference's uint32 words.

Out-of-range indices behave as in the reference's jnp indexing: a
negative index is wrapped once (``i + n``, as numpy does); a gather then
clamps into ``[0, n)`` and a scatter drops what is still outside.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.bitmap import (INT32_MIN, _popcount_words,
                                     _scatter_or_rows, drop_index, popcount)

OPS = ("or", "max")


def bitmap_update_ref(cand: torch.Tensor, visited: torch.Tensor):
    """Plain version of ``bitmap_update`` (kernel K4): ``new = cand &
    ~visited``, ``visited | new`` and the popcount of ``new`` as
    int32[1, 1], over words of any shape."""
    nf = cand & ~visited
    return nf, visited | nf, popcount(nf).reshape(1, 1)


def bitmap_update_batch_ref(cand: torch.Tensor, visited: torch.Tensor):
    """Plain version of ``bitmap_update_batch`` (kernel K3): the same P3
    over a stack of planes (axis 0), one popcount per plane as
    int32[g, 1, 1]."""
    nf = cand & ~visited
    cnt = _popcount_words(nf).reshape(nf.shape[0], -1).sum(
        1, dtype=torch.int32)
    return nf, visited | nf, cnt.reshape(-1, 1, 1)


def bitmap_update_rows_ref(cand: torch.Tensor, visited: torch.Tensor):
    """Plain version of ``bitmap_update_rows`` (kernel K3 on the engine's
    int32[n, nw] rows, plane j in column j): the same P3, one popcount
    per column as int32[nw, 1, 1]."""
    nf = cand & ~visited
    cnt = _popcount_words(nf).sum(0, dtype=torch.int32)
    return nf, visited | nf, cnt.reshape(-1, 1, 1)


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be 'or' or 'max', got {op!r}")


def _scatter_max_rows(words: torch.Tensor, row_idx: torch.Tensor,
                      msg: torch.Tensor) -> torch.Tensor:
    """Unsigned scatter-max: ``words[row_idx[e]] = umax(.., msg[e])``, OOR
    rows dropped.  int32 holds uint32 bits, so flipping bit 31 maps the
    unsigned order onto the signed one around ``scatter_reduce("amax")``."""
    r, nw = words.shape
    idx = drop_index(row_idx, r)
    acc = torch.cat([words, torch.zeros((1, nw), dtype=words.dtype,
                                        device=words.device)]) ^ INT32_MIN
    acc.scatter_reduce_(0, idx[:, None].expand(-1, nw), msg ^ INT32_MIN,
                        "amax")
    return acc[:r] ^ INT32_MIN


def scatter_combine(words: torch.Tensor, row_idx: torch.Tensor,
                    msg: torch.Tensor, op: str) -> torch.Tensor:
    _check_op(op)
    if op == "or":
        return _scatter_or_rows(words, row_idx, msg)
    return _scatter_max_rows(words, row_idx, msg)


def _p3(cand: torch.Tensor, seen: torch.Tensor):
    nf = cand & ~seen
    return nf, seen | nf, popcount(nf)


def msbfs_propagate_planes_ref(frontier: torch.Tensor, seen: torch.Tensor,
                               src: torch.Tensor, tgt: torch.Tensor,
                               op: str = "or", valid=None, n_edges=None):
    """Plain version of ``msbfs_propagate_planes`` (kernel K1).

    A slot is dropped where src or tgt lies outside ``[0, n_rows)`` (no
    wrapping), where ``valid`` (bool[m], optional) is False, or at and
    after ``n_edges`` (optional int or one-element tensor).  With a trash
    row that dropped slots point at (the older contract) the result is the
    same.  Returns (new, seen_out, count int32[1, 1])."""
    _check_op(op)
    n, m = frontier.shape[0], src.shape[0]
    s64, t64 = src.to(torch.int64), tgt.to(torch.int64)
    ok = (s64 >= 0) & (s64 < n) & (t64 >= 0) & (t64 < n)
    if valid is not None:
        ok &= valid
    if n_edges is not None:
        ok &= torch.arange(m, device=src.device) < n_edges
    msg = torch.where(ok[:, None], frontier[s64.clamp(0, max(n - 1, 0))], 0) \
        if n else frontier.new_zeros((m, frontier.shape[1]))
    cand = scatter_combine(torch.zeros_like(frontier), torch.where(ok, t64, n),
                           msg, op)
    nf, vout, cnt = _p3(cand, seen)
    return nf, vout, cnt.reshape(1, 1)


def msbfs_propagate_planes_tiled_ref(seen: torch.Tensor, msg: torch.Tensor,
                                     tgt: torch.Tensor,
                                     chunk_tile: torch.Tensor,
                                     tile_rows: int, block_edges: int,
                                     op: str = "or"):
    """Plain version of ``msbfs_propagate_planes_tiled`` (kernel K2).

    Slot e belongs to chunk ``e // block_edges`` and so to row tile
    ``chunk_tile[chunk]``; a target outside that tile is dropped, as the
    kernel drops it.  Every tile of ``seen`` gets P3 (the bucketing gives
    each tile at least one chunk).  Returns (new, seen_out, count[1, 1]).
    """
    _check_op(op)
    slot = torch.arange(msg.shape[0], device=msg.device)
    row0 = chunk_tile.to(torch.int64)[slot // block_edges] * tile_rows
    local = tgt.to(torch.int64) - row0
    rows = torch.where((local >= 0) & (local < tile_rows), tgt.to(torch.int64),
                       -1)
    cand = scatter_combine(torch.zeros_like(seen), rows, msg, op)
    nf, vout, cnt = _p3(cand, seen)
    return nf, vout, cnt.reshape(1, 1)


def msbfs_propagate_msgs_ref(seen: torch.Tensor, msg: torch.Tensor,
                             tgt: torch.Tensor, valid: torch.Tensor,
                             op: str = "or"):
    """Unpadded msgs-form semantics: scatter-combine ``msg[e]`` into row
    ``tgt[e]`` for every valid in-range edge, then P3.  Returns (new,
    seen_out, count scalar)."""
    _check_op(op)
    n = seen.shape[0]
    ok = valid & (tgt >= 0) & (tgt < n)
    msg = torch.where(ok[:, None], msg, 0)
    cand = scatter_combine(torch.zeros_like(seen), torch.where(ok, tgt, n),
                           msg, op)
    return _p3(cand, seen)


def _wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 indices with negatives wrapped once (``i + n``), as numpy and
    jnp indexing do; what stays outside ``[0, n)`` is left for the caller
    to clamp (a gather) or drop (a scatter)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def gather_pages_ref(edges_paged: torch.Tensor,
                     page_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_pages`` (kernel K5): ``out[i] =
    edges_paged[page_ids[i]]``, int32[m, page].  An id outside ``[0,
    num_pages)`` gives what jnp gives: wrapped once if negative, then
    clamped (torch's own indexing would raise instead)."""
    n = edges_paged.shape[0]
    return edges_paged[_wrap_index(page_ids, n).clamp(0, n - 1)]


def pull_spmv_blocks_ref(blocks: torch.Tensor, block_row: torch.Tensor,
                         block_col: torch.Tensor, row_first,
                         frontier: torch.Tensor,
                         num_row_blocks: int) -> torch.Tensor:
    """Plain version of ``pull_spmv_blocks`` (kernel K6): ``out[r] = sum
    over tiles i with block_row[i] == r of blocks[i] @
    frontier[block_col[i]]`` in f32, f32[num_row_blocks, b, L].  A row
    block with no tile is 0.  ``row_first`` is not needed (the sum starts
    from zeros), as in the reference's oracle; a ``block_col`` out of range
    is clamped and a ``block_row`` out of range dropped, after wrapping."""
    del row_first
    _, b, _ = blocks.shape
    ncb, _, lanes = frontier.shape
    col = _wrap_index(block_col, ncb).clamp(0, ncb - 1)
    prod = torch.bmm(blocks.to(torch.float32),
                     frontier[col].to(torch.float32))
    row = _wrap_index(block_row, num_row_blocks)
    row = torch.where((row >= 0) & (row < num_row_blocks), row,
                      num_row_blocks)
    out = torch.zeros((num_row_blocks + 1, b, lanes), dtype=torch.float32,
                      device=blocks.device)
    out.index_add_(0, row, prod)
    return out[:num_row_blocks]


NEG_INF = -1e30                 # the reference's mask value


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain version of ``flash_attention`` (kernel K7): softmax attention
    over q/k/v [BH, S, hd], computed in f32 and cast to q's dtype, masked
    with ``-1e30`` where causal.  Written in place where it can, so the
    score matrix exists once at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_ = torch.bmm(q.to(torch.float32),
                   k.to(torch.float32).transpose(1, 2)).mul_(scale)
    if causal:
        n, nk = q.shape[1], k.shape[1]
        mask = torch.ones((n, nk), dtype=torch.bool,
                          device=q.device).triu_(1)
        s_.masked_fill_(mask, NEG_INF)
    s_ = torch.softmax(s_, dim=-1)
    return torch.bmm(s_, v.to(torch.float32)).to(q.dtype)


def expand_frontier_ref(mask: torch.Tensor, indptr: torch.Tensor,
                        indices: torch.Tensor, budget: int):
    """Plain version of ``expand_frontier``: the engine's P1 compaction of
    ``mask`` and P2 expansion of those vertices' lists into ``budget``
    slots, as ``core.bfs_local`` writes them."""
    from repro_torch.core.bfs_local import compact_indices, expand_edges
    active, _ = compact_indices(mask, mask.numel())
    return expand_edges(active, indptr, indices, budget)
