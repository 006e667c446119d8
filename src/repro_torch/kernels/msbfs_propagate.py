"""Launch wrappers of the fused P2->P3 propagate kernels.

Port of ``repro.kernels.msbfs_propagate``.  Two kernels, hand-written in
CUDA C++ for Hopper (``csrc/msbfs_propagate.cu``, whose header note gives
their bound and design):

* ``msbfs_propagate_planes`` (K1) — whole plane arrays and the engine's
  edge list as it stands (src, tgt, the valid mask and the expansion's
  edge total on the device); three launches zero the accumulator,
  scatter-combine ``frontier[src]`` into it one slot a thread with
  warp-aggregated global atomics, and apply P3 + popcount.
* ``msbfs_propagate_planes_tiled`` (K2) — pre-gathered messages bucketed
  by target row tile; a persistent grid cuts the tiles' runs into equal
  slices, each tile's accumulator in shared memory, a tile split across
  CTAs finished by its last part.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a CUDA
tensor launches the kernel or raises.  Each wrapper counts its launches in
``LAUNCHES`` (one per call that reaches the card) and reports each call
to the step analysis counting, if any, at the bytes of
:func:`propagate_traffic` / :func:`tiled_traffic`.  Outputs are always
fresh tensors: the engine retries an overflowed level from its pre-step
state, which must never be written in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"msbfs_propagate_planes": 0, "msbfs_propagate_planes_tiled": 0}

# The most dynamic shared memory one H100 block may hold (227 KB).
MAX_SMEM_PER_BLOCK = 232448

_OP_CODE = {"or": 0, "max": 1}
_LIB = "msbfs_propagate"
_bound = False

# K1's launches (``csrc/msbfs_propagate.cu``): bit 1 zero, 2 scatter, 4 P3
PHASES_ALL = 0x7


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.msbfs_propagate_planes_launch
        f.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
        f.restype = i
        f = lib.msbfs_propagate_planes_tiled_launch
        f.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        f.restype = i
        _bound = True
    return lib


def msbfs_propagate_planes(frontier: torch.Tensor, seen: torch.Tensor,
                           src: torch.Tensor, tgt: torch.Tensor,
                           op: str = "or", valid: torch.Tensor | None = None,
                           n_edges: torch.Tensor | int | None = None):
    """Fused gather/scatter-combine/P3 over packed plane words (K1).

    frontier/seen: int32[n_rows, nw].
    src/tgt: int32[m]; a slot is dropped where src or tgt lies outside
        ``[0, n_rows)``, where ``valid`` (bool[m], optional) is False, or
        at and after ``n_edges`` (optional: a device int32 scalar, such as
        the expansion's edge total, or an int; beyond m it means m).  The
        kernel reads no slot at or after min(n_edges, m).  The older
        contract, a trash row (frontier 0, seen all-ones) that dropped
        slots point at, still holds: such slots add nothing.
    Returns (new, seen_out, count int32[1, 1]) with
    new = scatter_combine(frontier[src] -> tgt) & ~seen, seen_out =
    seen | new, count = popcount(new).
    """
    if _report.active is not None:
        return _report.active.kernel_call(
            "msbfs_propagate_planes", lambda: (propagate_traffic(
                frontier, src, tgt, valid, n_edges)["bytes"], 0.0),
            msbfs_propagate_planes, frontier, seen, src, tgt, op, valid,
            n_edges)
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    if frontier.device.type == "cpu":
        return ref.msbfs_propagate_planes_ref(frontier, seen, src, tgt, op,
                                              valid=valid, n_edges=n_edges)
    new, seen_out = torch.empty_like(frontier), torch.empty_like(seen)
    cnt = torch.empty((1, 1), dtype=torch.int32, device=frontier.device)
    args = whole_launch_args(frontier, seen, src, tgt, valid, n_edges, new,
                             seen_out, cnt, op)
    raise_on_error(_lib().msbfs_propagate_planes_launch(
        *args, PHASES_ALL, stream_ptr(frontier.device)),
        "msbfs_propagate_planes")
    LAUNCHES["msbfs_propagate_planes"] += 1
    return new, seen_out, cnt


def propagate_traffic(frontier: torch.Tensor, src: torch.Tensor,
                      tgt: torch.Tensor, valid: torch.Tensor | None = None,
                      n_edges=None) -> dict:
    """K1's bytes on these inputs: what the data makes it move, each
    input read once and each output written once.  The src (and valid)
    bytes of each slot below n_edges, the tgt of each real edge whose
    message is not zero, each distinct frontier row the real edges read,
    seen, the two outputs new and seen_out, and the count.  Returns
    {bytes, slots, real, live, rows}: the slots below n_edges, the real
    edges among them, those whose message is not zero, and the distinct
    source rows.  Reads the data back to the host."""
    n, nw = frontier.shape
    m = int(src.shape[0])
    slots = m if n_edges is None else min(max(int(n_edges), 0), m)
    s, t = src[:slots], tgt[:slots]
    ok = (s >= 0) & (s < n) & (t >= 0) & (t < n)
    if valid is not None:
        ok &= valid[:slots]
    s_ok = s[ok].to(torch.int64)
    real = int(s_ok.numel())
    live = int((frontier[s_ok] != 0).any(1).sum())
    rows = int(torch.unique(s_ok).numel())
    per_slot = 4 if valid is None else 5
    nbytes = slots * per_slot + live * 4 + rows * nw * 4 + 3 * n * nw * 4 + 4
    return dict(bytes=nbytes, slots=slots, real=real, live=live, rows=rows)


def tiled_traffic(seen: torch.Tensor, msg: torch.Tensor,
                  tile_chunks: torch.Tensor, block_edges: int) -> int:
    """K2's bytes on these inputs: the message of every slot in the
    tiles' head chunks (the slots it must read), the target of each slot
    whose message is not zero, seen, the two outputs new and seen_out,
    and the count.  Reads the data back to the host."""
    head = int(tile_chunks.clamp(min=0).sum()) * block_edges
    live = int((msg != 0).any(1).sum())
    return head * msg.shape[1] * 4 + live * 4 + 3 * seen.numel() * 4 + 4


def whole_launch_args(frontier, seen, src, tgt, valid, n_edges, new,
                      seen_out, cnt, op: str) -> tuple:
    """K1's checked arguments for its C launch function, up to its phases:
    (frontier, seen, src, tgt, valid, n_edges, new, seen_out, count, m,
    n_rows, nw, op).  An int ``n_edges`` is clamped into m here."""
    dev = frontier.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("frontier", frontier, torch.int32, 2, dev)
    check_arg("seen", seen, torch.int32, 2, dev)
    check_arg("src", src, torch.int32, 1, dev)
    check_arg("tgt", tgt, torch.int32, 1, dev)
    m = int(src.shape[0])
    if seen.shape != frontier.shape or tgt.shape != src.shape:
        raise ValueError(f"shape mismatch: frontier {tuple(frontier.shape)} "
                         f"seen {tuple(seen.shape)} src {tuple(src.shape)} "
                         f"tgt {tuple(tgt.shape)}")
    vptr = None
    if valid is not None:
        check_arg("valid", valid, torch.bool, 1, dev)
        if valid.shape != src.shape:
            raise ValueError(f"valid {tuple(valid.shape)} must match src "
                             f"{tuple(src.shape)}")
        vptr = valid.data_ptr()
    nptr = None
    if isinstance(n_edges, torch.Tensor):
        if n_edges.device != dev or n_edges.dtype != torch.int32 \
                or n_edges.numel() != 1:
            raise ValueError("n_edges must be one int32 on the frontier's "
                             f"device, got {n_edges.dtype} "
                             f"{tuple(n_edges.shape)} on {n_edges.device}")
        nptr = n_edges.data_ptr()
    elif n_edges is not None:
        m = min(max(int(n_edges), 0), m)
    n_rows, nw = frontier.shape
    return (frontier.data_ptr(), seen.data_ptr(), src.data_ptr(),
            tgt.data_ptr(), vptr, nptr, new.data_ptr(), seen_out.data_ptr(),
            cnt.data_ptr(), m, n_rows, nw, _OP_CODE[op])


def _tile_runs(chunk_tile: torch.Tensor, tile_chunks: torch.Tensor,
               num_tiles: int, block_edges: int):
    """Each tile's run of slots in the bucketed stream, for K2: (run_first
    int64[T], work_off int64[T + 1]), tile t's run being the slots
    [run_first[t], run_first[t] + work_off[t + 1] - work_off[t]).

    A run starts at the tile's first chunk in ``chunk_tile`` and holds
    ``tile_chunks[t]`` chunks, never more than reach the next tile's first
    chunk."""
    dev = chunk_tile.device
    chunk_off = torch.searchsorted(
        chunk_tile, torch.arange(num_tiles + 1, dtype=chunk_tile.dtype,
                                 device=dev))
    run = torch.minimum(chunk_off[1:] - chunk_off[:-1],
                        tile_chunks.to(torch.int64).clamp(min=0))
    work_off = torch.zeros(num_tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum(run * block_edges, 0, out=work_off[1:])
    return chunk_off[:-1] * block_edges, work_off


def _load_widths(seen, msg, new, seen_out, tile_rows: int
                 ) -> tuple[int, int]:
    """K2's load widths: (vec, vec4).  vec, the words of one message load:
    4 or 2 where they divide nw and the stream is aligned to them, else 1;
    vec4, 1 where P3 moves uint4s (the tile's words a multiple of 4 and
    the plane arrays 16-byte aligned), else 0."""
    nw = seen.shape[1]
    vec = next((v for v in (4, 2)
                if nw % v == 0 and msg.data_ptr() % (4 * v) == 0), 1)
    vec4 = int((tile_rows * nw) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (seen, new, seen_out)))
    return vec, vec4


def msbfs_propagate_planes_tiled(seen: torch.Tensor, msg: torch.Tensor,
                                 tgt: torch.Tensor, chunk_tile: torch.Tensor,
                                 tile_chunks: torch.Tensor, tile_rows: int,
                                 block_edges: int, op: str = "or"):
    """Row-tiled fused scatter-combine/P3 over pre-gathered messages (K2).

    seen: int32[R, nw], R a multiple of ``tile_rows`` (pad rows all-ones).
    msg: int32[L, nw] message stream, L = NC * block_edges, bucketed so
        chunk c holds only edges of tile ``chunk_tile[c]`` (pad slots carry
        msg = 0, the identity of both combines).
    tgt: int32[L] GLOBAL target rows inside their chunk's tile.
    chunk_tile: int32[NC] nondecreasing tile id per chunk, covering every
        tile at least once.
    tile_chunks: int32[R // tile_rows], the chunks at the head of each
        tile's run that hold its real edges (the bucketing's counts); the
        kernel reads no chunk after them, so they must carry only zero
        messages.  The plain version reads every chunk.
    Returns (new, seen_out, count int32[1, 1]).
    """
    if _report.active is not None:
        return _report.active.kernel_call(
            "msbfs_propagate_planes_tiled", lambda: (tiled_traffic(
                seen, msg, tile_chunks, block_edges), 0.0),
            msbfs_propagate_planes_tiled, seen, msg, tgt, chunk_tile,
            tile_chunks, tile_rows, block_edges, op)
    if op not in _OP_CODE:
        raise ValueError(f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    r, nw = seen.shape
    if tile_rows < 1 or r % tile_rows:
        raise ValueError(f"rows {r} must be a multiple of tile_rows "
                         f"{tile_rows}")
    if msg.shape[0] != chunk_tile.shape[0] * block_edges:
        raise ValueError(f"msg rows {msg.shape[0]} != chunks "
                         f"{chunk_tile.shape[0]} x block_edges {block_edges}")
    num_tiles = r // tile_rows
    if tuple(tile_chunks.shape) != (num_tiles,):
        raise ValueError(f"tile_chunks must be [{num_tiles}], got "
                         f"{tuple(tile_chunks.shape)}")
    if seen.device.type == "cpu":
        return ref.msbfs_propagate_planes_tiled_ref(
            seen, msg, tgt, chunk_tile, tile_rows, block_edges, op)
    dev = seen.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("seen", seen, torch.int32, 2, dev)
    check_arg("msg", msg, torch.int32, 2, dev)
    check_arg("tgt", tgt, torch.int32, 1, dev)
    check_arg("chunk_tile", chunk_tile, torch.int32, 1, dev)
    check_arg("tile_chunks", tile_chunks, torch.int32, 1, dev)
    if msg.shape[1] != nw or tgt.shape[0] != msg.shape[0]:
        raise ValueError(f"shape mismatch: seen {tuple(seen.shape)} msg "
                         f"{tuple(msg.shape)} tgt {tuple(tgt.shape)}")
    smem = tile_rows * nw * 4
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"tile accumulator {smem} B exceeds the "
                         f"{MAX_SMEM_PER_BLOCK} B a block may hold")
    run_first, work_off = _tile_runs(chunk_tile, tile_chunks, num_tiles,
                                     block_edges)
    new = torch.zeros_like(seen)        # split tiles' partial sums land here
    seen_out = torch.empty_like(seen)
    scratch = torch.zeros(num_tiles + 1, dtype=torch.int32, device=dev)
    err = _launch_tiled(seen, msg, tgt, run_first, work_off, new, seen_out,
                        scratch, tile_rows, op,
                        _load_widths(seen, msg, new, seen_out, tile_rows))
    raise_on_error(err, "msbfs_propagate_planes_tiled")
    LAUNCHES["msbfs_propagate_planes_tiled"] += 1
    return new, seen_out, scratch[:1].view(1, 1)


def _launch_tiled(seen, msg, tgt, run_first, work_off, new, seen_out,
                  scratch, tile_rows: int, op: str, widths: tuple[int, int]
                  ) -> int:
    """K2's C launch on checked, prepared buffers: ``new`` and ``scratch``
    (int32[num_tiles + 1]: the count, then the tiles' arrival counters)
    zeroed, ``widths`` = (vec, vec4) as :func:`_load_widths` gives them.
    Returns the launch's CUDA error code."""
    r, nw = seen.shape
    vec, vec4 = widths
    return _lib().msbfs_propagate_planes_tiled_launch(
        seen.data_ptr(), msg.data_ptr(), tgt.data_ptr(), run_first.data_ptr(),
        work_off.data_ptr(), new.data_ptr(), seen_out.data_ptr(),
        scratch.data_ptr(), scratch[1:].data_ptr(), r // tile_rows,
        tile_rows, nw, _OP_CODE[op], vec, vec4, stream_ptr(seen.device))
