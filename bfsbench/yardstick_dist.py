"""Frozen arithmetic of the four-card cells: the links' peak and the bytes
the distributed engine's pull kernel K2 must move on the inputs of a
call.

Copies, frozen here so that a change to the program cannot move the
yardstick: NVLink 4's rate per direction of one H100 SXM (NVIDIA's data
sheet: 900 GB/s of NVLink bandwidth a card, both directions together),
and K2's bytes from ``repro_torch.kernels.msbfs_propagate.tiled_traffic``.
Each input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import torch

# One H100 SXM's NVLink 4, one direction: half of the 900 GB/s a card.
NVLINK_BYTES_PER_S = 450e9

# K2 (``csrc/msbfs_propagate.cu``: the row-tiled propagate) by its symbol;
# NCCL's device kernels by the prefix of theirs.
K2_SYMBOLS = ("propagate_tiled_kernel",)
NCCL_PREFIX = "nccl"


def is_nccl(name: str) -> bool:
    """A collective's kernel (``ncclDevKernel_...``, ``ncclKernel_...``)."""
    return name.lower().startswith(NCCL_PREFIX)


def k2_bytes(seen: torch.Tensor, msg: torch.Tensor,
             tile_chunks: torch.Tensor, block_edges: int) -> torch.Tensor:
    """K2's bytes on these inputs: the message of every slot in the tiles'
    head chunks (the slots it must read), the target of each slot whose
    message is not zero, seen read, new and seen_out written, and the
    int32 count.  An int64 scalar on the inputs' device, computed on
    their stream: it does not synchronise."""
    head = tile_chunks.clamp(min=0).sum(dtype=torch.int64) * int(block_edges)
    live = msg.ne(0).any(1).sum(dtype=torch.int64)
    return (head * (msg.shape[1] * 4) + live * 4
            + (3 * seen.numel() * 4 + 4))


def link_share(nbytes: float, seconds: float) -> float | None:
    """Percent of one card's NVLink bound, one direction, that ``seconds``
    of collective device time reached sending ``nbytes``; None without
    time."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / NVLINK_BYTES_PER_S) / seconds
