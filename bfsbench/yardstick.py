"""Frozen arithmetic of the benchmark: the card's peaks and the bytes the
port's kernels must move on the inputs of a call.

Copies, frozen here so that a change to the program cannot move the
yardstick: the H100's bandwidth from ``repro_torch.launch.roofline.H100``,
K1's bytes from ``repro_torch.kernels.msbfs_propagate.propagate_traffic``
and K4's from ``repro_torch.kernels.bitmap_update.p3_bytes``.  Each input
byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import torch

# One H100 SXM, NVIDIA's data sheet: 3.35 TB/s of HBM3 at 700 W.
HBM_BYTES_PER_S = 3.35e12

# The port's K1 and K4 by their kernels' symbols (``csrc/msbfs_propagate.cu``:
# K1's three launches; ``csrc/bitmap_update.cu``: K4's one).
K1_SYMBOLS = ("whole_zero_kernel", "whole_scatter_kernel", "whole_p3_kernel")
K4_SYMBOLS = ("p3_planes_kernel",)
# Every kernel of the port's own K1-K7 (the ``__global__``s of
# ``src/repro_torch/kernels/csrc``), frozen: any other kernel in a trace is
# the step's glue, a kernel a later change adds among them.
PORT_SYMBOLS = frozenset(K1_SYMBOLS + K4_SYMBOLS + (
    "propagate_tiled_kernel",                  # K2
    "p3_rows_kernel",                          # K3 (planes-major: K4's)
    "gather_pages_kernel",                     # K5
    "pull_spmv_wgmma_kernel",                  # K6
    "flash_kernel", "flash_tc_kernel",         # K7
))


def k1_bytes(frontier: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
             valid: torch.Tensor | None = None, n_edges=None) -> int:
    """K1's bytes on these inputs: the src (and valid) bytes of each slot
    below ``n_edges``, the tgt of each real edge whose message is not zero,
    each distinct frontier row the real edges read, seen read, new and
    seen_out written, and the int32 count.  Reads the data back to the
    host (it synchronises)."""
    n, nw = frontier.shape
    m = int(src.shape[0])
    slots = m if n_edges is None else min(max(int(n_edges), 0), m)
    s, t = src[:slots], tgt[:slots]
    ok = (s >= 0) & (s < n) & (t >= 0) & (t < n)
    if valid is not None:
        ok &= valid[:slots]
    s_ok = s[ok].to(torch.int64)
    live = int((frontier[s_ok] != 0).any(1).sum())
    rows = int(torch.unique(s_ok).numel())
    per_slot = 4 if valid is None else 5
    return slots * per_slot + live * 4 + rows * nw * 4 + 3 * n * nw * 4 + 4


def k4_bytes(cand: torch.Tensor) -> int:
    """K4's bytes: cand and visited read, new and visited_out written
    (int32 words each), and one int32 count."""
    return 16 * int(cand.numel()) + 4


def roofline_share(nbytes: float, seconds: float) -> float | None:
    """Percent of the card's HBM bound that ``seconds`` of device time
    reached moving ``nbytes``; None without device time."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds
