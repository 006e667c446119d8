"""Launch wrapper of the block-sparse boolean pull SpMV kernel.

Port of ``repro.kernels.pull_spmv``.  One kernel, hand-written in CUDA C++
for Hopper (``csrc/pull_spmv.cu``, whose header note gives its bound and
design):

* ``pull_spmv_blocks`` (K6) — ``out[block_row[i]] += blocks[i] @
  frontier[block_col[i]]`` over bf16 0/1 tiles, accumulated in f32 by
  wgmma on the tensor cores (exact: 0/1 products, integer sums below
  2^24); the caller's ``> 0`` is the OR-AND product of pull-mode BFS over
  the dense hub blocks of a scale-free graph.

A row block with no tile is 0 (the reference's oracle; its TPU kernel
left such rows unwritten).  A tensor on the CPU goes to the plain version
in ``kernels.ref``; a CUDA tensor launches the kernel or raises.  The
wrapper counts its launches in ``LAUNCHES`` and reports each call to the
step analysis counting, if any, at :func:`spmv_cost`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"pull_spmv_blocks": 0}

_LIB = "pull_spmv"
_MAX_TILES = 2**31 - 1       # the grid's x extent
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.pull_spmv_blocks_launch
        f.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]
        f.restype = i
        _bound = True
    return lib


def spmv_cost(blocks: torch.Tensor, frontier: torch.Tensor,
              num_row_blocks: int) -> tuple[int, float]:
    """K6's (bytes, FLOPs): every tile, the frontier and the two int32
    block indices read, the f32 output written; two FLOPs for each
    (row, col, lane) of every tile."""
    nb, b, _ = blocks.shape
    lanes = frontier.shape[2]
    nbytes = (blocks.numel() * blocks.element_size()
              + frontier.numel() * frontier.element_size()
              + int(num_row_blocks) * b * lanes * 4 + 2 * nb * 4)
    return nbytes, 2.0 * nb * b * b * lanes


def pull_spmv_blocks(blocks: torch.Tensor, block_row: torch.Tensor,
                     block_col: torch.Tensor, row_first,
                     frontier: torch.Tensor,
                     num_row_blocks: int) -> torch.Tensor:
    """Block-sparse boolean SpMV (K6).

    blocks: bf16[nb, b, b] 0/1 adjacency tiles (CSC orientation: rows =
        children, cols = parents), sorted by row.
    block_row / block_col: int32[nb] output row block and frontier column
        block of each tile.
    row_first: ignored, may be None; kept for the reference's signature
        (the kernel adds the sums of each run of tiles into a zeroed
        output, so it needs no mark of where a row run starts).
    frontier: bf16[ncb, b, L] frontier lanes per column block.
    Returns f32[num_row_blocks, b, L]; OR == (out > 0).
    """
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be [nb, b, b], got "
                         f"{tuple(blocks.shape)}")
    nb, b, _ = blocks.shape
    if frontier.dim() != 3 or frontier.shape[1] != b:
        raise ValueError(f"frontier must be [ncb, {b}, L], got "
                         f"{tuple(frontier.shape)}")
    if block_row.shape != (nb,) or block_col.shape != (nb,):
        raise ValueError(f"block_row/block_col must be [{nb}], got "
                         f"{tuple(block_row.shape)}/{tuple(block_col.shape)}")
    num_row_blocks = int(num_row_blocks)
    if _report.active is not None:
        return _report.active.kernel_call(
            "pull_spmv_blocks",
            lambda: spmv_cost(blocks, frontier, num_row_blocks),
            pull_spmv_blocks, blocks, block_row, block_col, row_first,
            frontier, num_row_blocks)
    if blocks.device.type == "cpu":
        return ref.pull_spmv_blocks_ref(blocks, block_row, block_col,
                                        row_first, frontier, num_row_blocks)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("blocks", blocks, torch.bfloat16, 3, dev)
    check_arg("block_row", block_row, torch.int32, 1, dev)
    check_arg("block_col", block_col, torch.int32, 1, dev)
    check_arg("frontier", frontier, torch.bfloat16, 3, dev)
    ncb, _, lanes = frontier.shape
    if nb > _MAX_TILES:
        raise ValueError(f"{nb} tiles exceed the kernel's {_MAX_TILES}")
    if nb and ncb == 0:
        raise ValueError("frontier has no column block")
    out = torch.zeros((num_row_blocks, b, lanes), dtype=torch.float32,
                      device=dev)
    if nb and b and lanes and num_row_blocks:
        err = _lib().pull_spmv_blocks_launch(
            blocks.data_ptr(), block_row.data_ptr(), block_col.data_ptr(),
            frontier.data_ptr(), out.data_ptr(), int(nb), int(b), int(lanes),
            int(ncb), num_row_blocks, stream_ptr(dev))
        raise_on_error(err, "pull_spmv_blocks")
        LAUNCHES["pull_spmv_blocks"] += 1
    return out
