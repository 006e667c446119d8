"""Glue between the engines and the kernels (port of
``repro.kernels.ops``).

``fused_frontier_update`` and ``fused_frontier_update_rows`` are the P3
entries of the single-source runner and the bool-plane baseline;
``fused_frontier_update_batch`` is the reference's planes-major entry.
``msbfs_propagate`` picks the kernel with ``propagate_plan``: the
whole-array kernel takes the engine's edge list as it stands (it drops
invalid and out-of-range slots itself), the tiled path masks and buckets
it; ``msbfs_propagate_msgs`` is the tiled entry for messages gathered
elsewhere.  Everything here is plain PyTorch with sizes
fixed by Python ints, so no call synchronises with the host.

``build_page_table`` / ``read_neighbor_pages`` (the HBM reader, kernel K5)
and ``pull_spmv`` (the block-sparse boolean SpMV, kernel K6) have no engine
path in either package: they are entry points of their own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitmap_update import (bitmap_update,
                                               bitmap_update_batch,
                                               bitmap_update_rows)
from repro_torch.kernels.csr_gather import gather_pages
from repro_torch.kernels.msbfs_propagate import (
    MAX_SMEM_PER_BLOCK, msbfs_propagate_planes, msbfs_propagate_planes_tiled)
from repro_torch.kernels.pull_spmv import pull_spmv_blocks


def fused_frontier_update(cand_words: torch.Tensor,
                          visited_words: torch.Tensor, out=None):
    """P3 update on flat int32[w] words; returns (new, visited, count), the
    count an int32 scalar view.  ``out``: optional (new, visited, count
    int32[1, 1]) buffers for kernel K4 to write (see ``bitmap_update``).

    The reference pads ``w`` to 128-word rows in blocks of at most 16 rows
    (``_pad_rows_to_block``, the TPU's grid plan); kernel K4 takes any
    ``w`` as it is, so nothing is padded here."""
    nf, vo, cnt = bitmap_update(cand_words, visited_words, out=out)
    return nf, vo, cnt[0, 0]


def fused_frontier_update_batch(cand_words: torch.Tensor,
                                visited_words: torch.Tensor):
    """P3 update on a stack of planes: int32[g, w] -> (new, visited,
    counts[g]), one popcount per plane (kernel K3)."""
    nf, vo, cnt = bitmap_update_batch(cand_words, visited_words)
    return nf, vo, cnt.reshape(-1)


def fused_frontier_update_rows(cand_words: torch.Tensor,
                               visited_words: torch.Tensor):
    """P3 update on the engine's planes as they are: int32[n, nw], plane j
    in column j -> (new, visited, counts[nw]) (kernel K3's rows form; no
    transposes)."""
    nf, vo, cnt = bitmap_update_rows(cand_words, visited_words)
    return nf, vo, cnt.reshape(-1)


# The propagate plan.  The reference tiles once the four plane arrays
# outgrow its 2 MiB VMEM budget (PROPAGATE_VMEM_BYTES).  On the H100 the
# auto plan is the whole-array kernel K1 at every size: the tiled path
# must sort and bucket the whole edge budget before K2 runs, and in
# ``chip_smoke.py`` (o)'s turns the whole-array wave won both inside the
# 50 MB L2 (rmat20-16, B = 64, 34 MB of planes) and outside it (B = 256,
# 134 MB), though K2 alone beat K1 at both (PERF.md).  Tiles are taken
# when asked for (``tile_rows`` > 0) and by the msgs form, whose caller
# gathered the messages already.
#
# ``MAX_SMEM_PER_BLOCK``, the most dynamic shared memory one H100 block
# may hold (227 KB), sizes what the tiled path holds:
#  * tile size: the tiled kernel holds one tile's accumulator (4 * nw
#    bytes a row); budgeting 32 * nw bytes a row (1/8 of the budget per
#    tile) keeps four of K2's persistent CTAs resident on each SM;
#  * chunk length: a chunk of messages stays 1/8 of the budget, which
#    bounds the pad slots the bucketing adds (at most one chunk per tile).


def _plane_footprint_bytes(n_rows: int, nw: int) -> int:
    """Whole-array working set: 4 plane arrays incl. the trash row (the
    reference's rule, which ``propagate_plan`` reports as it is)."""
    return 4 * (n_rows + 1) * nw * 4


def _auto_tile_rows(nw: int) -> int:
    """Tile-size rule: 32 * nw budget bytes per row (see the budget note
    above), rounded down to a multiple of 8 rows."""
    return max((MAX_SMEM_PER_BLOCK // (32 * nw)) // 8 * 8, 8)


def _auto_block_edges(m: int, nw: int) -> int:
    """Edge-chunk length of the bucketed message stream: grows with m to
    target <= 256 chunks, capped so one chunk of messages is 1/8 of the
    budget, always a multiple of 1024."""
    cap = max((MAX_SMEM_PER_BLOCK // (8 * 4 * nw)) // 1024 * 1024, 1024)
    need = -(-(-(-m // 256)) // 1024) * 1024
    return int(min(max(need, 1024), cap))


def propagate_plan(n_rows: int, nw: int,
                   tile_rows: int | None = None) -> dict:
    """Whole-array vs row-tiled selection for ``msbfs_propagate``.

    ``tile_rows``: None = auto (the whole-array kernel at every size; see
    the plan note above), 0 = force whole-array, > 0 = force tiling at
    that size.  Returns dict(tiled, tile_rows, num_tiles, footprint_bytes).
    """
    fp = _plane_footprint_bytes(n_rows, nw)
    if tile_rows is None or tile_rows == 0:
        return dict(tiled=False, tile_rows=0, num_tiles=1,
                    footprint_bytes=fp)
    tile_rows = int(tile_rows)
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    return dict(tiled=True, tile_rows=tile_rows,
                num_tiles=-(-n_rows // tile_rows), footprint_bytes=fp)


def _gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` for int32 rows.  PyTorch's CUDA row gather is many
    times slower when a row is a multiple of 16 bytes (nw = 4, 8, ...)
    than for 8-byte rows, so such rows are gathered as 8-byte pieces."""
    nw = rows.shape[1]
    if nw % 4:
        return rows[idx]
    k = nw // 2
    pieces = idx[:, None] * k + torch.arange(k, device=idx.device)
    return rows.view(-1, 2)[pieces.view(-1)].view(-1, nw)


def _key_starts(keys_sorted: torch.Tensor, num_keys: int) -> torch.Tensor:
    """starts[k] for k in [0, num_keys]: how many sorted keys lie below k,
    so key k's run is starts[k]..starts[k + 1] (int64).  The bucket counts
    without a contended ``scatter_add_``; keys above ``num_keys - 1`` (the
    dropped edges) come after starts[num_keys]."""
    return torch.searchsorted(keys_sorted, torch.arange(
        num_keys + 1, dtype=keys_sorted.dtype, device=keys_sorted.device))


def _bucket_edges_by_tile(rows: torch.Tensor, tgt: torch.Tensor,
                          ok: torch.Tensor, num_tiles: int, tile_rows: int,
                          block_edges: int, row_of=None):
    """Bucket an edge list by target row tile, gathering each edge's
    message straight into its stream slot: ``rows[row_of[e]]``, or
    ``rows[e]`` when ``row_of`` is None (pre-gathered messages, as the
    reference's ``_bucket_edges_by_tile`` takes them; the first three
    outputs then equal its three).

    A stable sort of the tile keys groups edges by ``tgt // tile_rows``
    (int16 keys while the tile count allows, else int32); each tile's
    bucket is cut into ``block_edges``-sized chunks, and the chunks are
    laid out tile-major so ``chunk_tile`` is nondecreasing.  Chunk capacity
    follows the actual bucket sizes (a hub target simply gets more
    chunks), within the static bound ceil(m / C) + T; empty tiles get one
    pad chunk so their P3 still runs.  The bucket sizes come from the
    sorted keys (:func:`_key_starts`).  Each slot then finds its edge (tile,
    rank in the tile, sorted position) and gathers it, so the stream is
    written once.

    rows: int32[k, nw] message rows; tgt: int[m] global target rows, m >
    0; ``ok`` False slots are dropped.  Returns (stream_msg int32[L, nw],
    stream_tgt int32[L], chunk_tile int32[NC], tile_chunks int32[T]) with
    L = NC * block_edges; pad slots carry msg = 0 aimed at their chunk's
    tile base row; ``tile_chunks[t]`` counts tile t's chunks that hold
    edges (0 for an empty tile), the head of its run.
    """
    dev = tgt.device
    m, nw = tgt.shape[0], rows.shape[1]
    t_, c_ = num_tiles, block_edges
    num_chunks = -(-m // c_) + t_
    key = torch.int16 if t_ + 1 < 2**15 else torch.int32
    tile = torch.where(ok, torch.div(tgt, tile_rows, rounding_mode="floor"),
                       t_).to(key)
    tile_s, order = torch.sort(tile, stable=True)
    seg = _key_starts(tile_s, t_)
    counts = seg[1:] - seg[:-1]
    tile_chunks = -(-counts // c_)
    chunks_per_tile = tile_chunks.clamp(min=1)
    cum_chunks = torch.cumsum(chunks_per_tile, 0)
    chunk_off = cum_chunks - chunks_per_tile
    # tile id per chunk; trailing unused chunks ride the last tile so the
    # sequence stays nondecreasing and the last tile's P3 stays last
    chunk = torch.arange(num_chunks, dtype=torch.int64, device=dev)
    chunk_tile = torch.searchsorted(cum_chunks, chunk,
                                    right=True).clamp(max=t_ - 1)
    # per chunk: its first edge's rank in the tile, and that edge's
    # sorted position; per slot: real iff its rank < the tile's count
    first_rank = (chunk - chunk_off[chunk_tile]) * c_
    lane = torch.arange(c_, dtype=torch.int64, device=dev)
    real = lane < (counts[chunk_tile] - first_rank)[:, None]
    pos = ((seg[:-1][chunk_tile] + first_rank)[:, None] + lane).clamp_(
        max=m - 1)
    edge = order[pos]                            # [NC, C]
    src_row = edge if row_of is None else row_of[edge].to(torch.int64)
    rows1 = torch.cat([rows, torch.zeros((1, nw), dtype=rows.dtype,
                                         device=dev)])
    stream_msg = _gather_rows(rows1, torch.where(real, src_row,
                                                 rows.shape[0]).view(-1))
    base = (chunk_tile * tile_rows).to(torch.int32)
    stream_tgt = torch.where(real, tgt.to(torch.int32)[edge], base[:, None])
    return (stream_msg, stream_tgt.view(-1), chunk_tile.to(torch.int32),
            tile_chunks.to(torch.int32))


def _tiled_inputs(seen_w: torch.Tensor, rows: torch.Tensor, row_of,
                  tgt: torch.Tensor, ok: torch.Tensor, tile_rows: int,
                  block_edges: int):
    """Kernel K2's inputs: ``seen`` padded to a tile multiple with all-ones
    rows (stray writes there never count as discoveries), plus the
    bucketed stream of the messages ``rows[row_of[e]]`` (``row_of`` None:
    ``rows[e]``).  Returns (seen_padded, stream_msg, stream_tgt,
    chunk_tile, tile_chunks)."""
    n, nw = seen_w.shape
    t_ = -(-n // tile_rows)
    r_ = t_ * tile_rows
    if r_ > n:
        seen_w = torch.cat([seen_w, torch.full((r_ - n, nw), -1,
                                               dtype=seen_w.dtype,
                                               device=seen_w.device)])
    return (seen_w, *_bucket_edges_by_tile(rows, tgt, ok, t_, tile_rows,
                                           block_edges, row_of))


def _propagate_tiled(seen_w, rows, row_of, tgt, ok, tile_rows: int,
                     block_edges: int, op: str):
    """Shared tiled-path tail: pad rows to a tile multiple, bucket, run."""
    n = seen_w.shape[0]
    new, vout, cnt = msbfs_propagate_planes_tiled(
        *_tiled_inputs(seen_w, rows, row_of, tgt, ok, tile_rows, block_edges),
        tile_rows, block_edges, op)
    return new[:n], vout[:n], cnt[0, 0]


def _edge_ok(valid, src, tgt, n):
    ok = valid & (tgt >= 0) & (tgt < n)
    return ok if src is None else ok & (src >= 0) & (src < n)


def msbfs_propagate(frontier_w: torch.Tensor, seen_w: torch.Tensor,
                    src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                    block_edges: int | None = None, op: str = "or",
                    tile_rows: int | None = None, n_edges=None):
    """Fused P2->P3 propagate: gather ``frontier_w[src]`` words and
    scatter-combine them into the candidate planes at ``tgt`` (``op``:
    "or" for bit-planes, "max" for payload planes), then commit
    ``new = cand & ~seen`` / ``seen |= new``.

    frontier_w/seen_w: int32[n_pad, nw] packed plane words.
    src/tgt: int[m] edge endpoints; slots with ``valid`` False (or any
    out-of-range index), and slots at and after ``n_edges`` (optional: the
    expansion's edge total as a device int32 scalar, or an int), are
    dropped.  ``tile_rows`` picks the kernel (see :func:`propagate_plan`);
    ``block_edges`` (None = auto) is the tiled path's chunk length.  The
    whole-array kernel reads the inputs as they are and no slot at or
    after ``n_edges``.  Returns (new, seen_out, new_count).
    """
    n, nw = frontier_w.shape
    m = src.shape[0]
    if m == 0:
        return (torch.zeros_like(frontier_w), seen_w,
                torch.zeros((), dtype=torch.int32, device=seen_w.device))
    plan = propagate_plan(n, nw, tile_rows)
    if plan["tiled"]:
        if block_edges is None:
            block_edges = _auto_block_edges(m, nw)
        ok = _edge_ok(valid, src, tgt, n)
        if n_edges is not None:
            ok &= torch.arange(m, dtype=torch.int32, device=src.device) \
                < n_edges
        # the bucketing gathers frontier rows straight into the stream:
        # the tiled kernel never reads the frontier itself
        return _propagate_tiled(seen_w, frontier_w, src, tgt, ok,
                                plan["tile_rows"], block_edges, op)
    new, vout, cnt = msbfs_propagate_planes(
        frontier_w, seen_w, src.to(torch.int32), tgt.to(torch.int32), op=op,
        valid=valid, n_edges=n_edges)
    return new, vout, cnt[0, 0]


def msbfs_propagate_msgs(seen_w: torch.Tensor, msg: torch.Tensor,
                         tgt: torch.Tensor, valid: torch.Tensor,
                         tile_rows: int | None = None,
                         block_edges: int | None = None, op: str = "or"):
    """Msgs-form fused propagate: like :func:`msbfs_propagate` with the
    frontier gather already done — ``msg[e]`` is the packed word edge
    ``e`` carries into row ``tgt[e]``.  Always runs the row-tiled kernel;
    ``tile_rows`` defaults to the tile-size rule (``_auto_tile_rows``).
    Returns (new, seen_out, new_count)."""
    n, nw = seen_w.shape
    m = tgt.shape[0]
    if m == 0:
        return (torch.zeros_like(seen_w), seen_w,
                torch.zeros((), dtype=torch.int32, device=seen_w.device))
    if block_edges is None:
        block_edges = _auto_block_edges(m, nw)
    if tile_rows is None:
        tile_rows = min(_auto_tile_rows(nw), n)
    tile_rows = int(tile_rows)
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    ok = _edge_ok(valid, None, tgt, n)
    return _propagate_tiled(seen_w, msg, None, tgt, ok, tile_rows,
                            block_edges, op)


def build_page_table(starts: np.ndarray, degrees: np.ndarray, page: int,
                     budget_pages: int):
    """Host-side helper: (start, degree) pairs -> page table + masks.

    Returns (page_ids int32[budget_pages], item_vertex int32[budget_pages],
    first_offset int32[budget_pages]): work item i fetches page
    ``page_ids[i]`` of vertex ``item_vertex[i]``'s neighbour list, whose
    first page starts the list at ``first_offset``.  Vertices with degree
    <= 0 get no item; pad items fetch page 0 for owner -1.  Raises
    OverflowError above the budget.  The same arrays as the reference's
    per-vertex loop, computed vectorised.
    """
    n = min(len(starts), len(degrees))
    s = np.asarray(starts, np.int64)[:n]
    d = np.asarray(degrees, np.int64)[:n]
    live = np.flatnonzero(d > 0)
    s, d = s[live], d[live]
    p0 = s // page
    npg = (s + d - 1) // page - p0 + 1
    k = int(npg.sum())
    if k > budget_pages:
        raise OverflowError(f"page table {k} > budget {budget_pages}")
    first = np.cumsum(npg) - npg                # each vertex's first item
    item = np.arange(k, dtype=np.int64)
    page_ids = np.zeros(budget_pages, np.int32)
    owner = np.full(budget_pages, -1, np.int32)
    offs = np.zeros(budget_pages, np.int32)
    page_ids[:k] = np.repeat(p0 - first, npg) + item
    owner[:k] = np.repeat(live, npg)
    offs[first] = s - p0 * page
    return page_ids, owner, offs


def read_neighbor_pages(edges: torch.Tensor, page_ids: torch.Tensor,
                        page: int) -> torch.Tensor:
    """HBM-reader op: fetch the pages listed in ``page_ids`` (kernel K5).

    ``edges`` is the flat int32 edge array, padded to a page multiple.
    Returns int32[m, page]."""
    return gather_pages(edges.view(-1, page), page_ids)


def pull_spmv(blocks: torch.Tensor, block_row: torch.Tensor,
              block_col: torch.Tensor, frontier: torch.Tensor,
              num_row_blocks: int) -> torch.Tensor:
    """Boolean block SpMV (kernel K6); returns the OR result as
    bool[num_row_blocks, b, L].  The reference derives ``row_first`` here
    for its sequential grid; K6 adds every tile into a zeroed output and
    reads no ``row_first``, so none is built."""
    acc = pull_spmv_blocks(blocks, block_row, block_col, None, frontier,
                           num_row_blocks)
    return acc > 0
