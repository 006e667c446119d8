"""Launch wrappers of the fused P3 bitmap-update kernels.

Port of ``repro.kernels.bitmap_update``.  Two kernels, hand-written in CUDA
C++ for Hopper (``csrc/bitmap_update.cu``, whose header note gives their
bound and design), both computing ``new = cand & ~visited``, ``visited |
new`` and the popcount of ``new``:

* ``bitmap_update`` (K4) — one flat frontier of int32[w] words, one count;
  the single-source ``BFSRunner``'s P3.
* ``bitmap_update_batch`` (K3) — a planes-major stack int32[g, w], one
  count per plane; the bool-plane baseline's P3.

The TPU kernels took ``[rows, 128]`` word tiles padded to whole row
blocks; these take any ``w`` as it is.  A tensor on the CPU goes to the
plain version in ``kernels.ref``; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``LAUNCHES``.  Outputs are
fresh tensors: the engines retry an overflowed level from its pre-step
state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"bitmap_update": 0, "bitmap_update_batch": 0}

_LIB = "bitmap_update"
_MAX_PLANES = 65535          # the grid's y extent
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.bitmap_update_launch
        f.argtypes = [p, p, p, p, p, ll, p]
        f.restype = i
        f = lib.bitmap_update_batch_launch
        f.argtypes = [p, p, p, p, p, i, ll, p]
        f.restype = i
        _bound = True
    return lib


def _checked_device(cand: torch.Tensor, visited: torch.Tensor,
                    ndim: int) -> torch.device:
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("cand", cand, torch.int32, ndim, dev)
    check_arg("visited", visited, torch.int32, ndim, dev)
    if cand.shape != visited.shape:
        raise ValueError(f"shape mismatch: cand {tuple(cand.shape)} visited "
                         f"{tuple(visited.shape)}")
    return dev


def bitmap_update(cand: torch.Tensor, visited: torch.Tensor):
    """Fused P3 on one frontier (K4).

    cand/visited: int32[w] packed words.  Returns (new, visited_out,
    count int32[1, 1])."""
    if cand.device.type == "cpu":
        return ref.bitmap_update_ref(cand, visited)
    dev = _checked_device(cand, visited, 1)
    new = torch.empty_like(cand)
    vout = torch.empty_like(visited)
    cnt = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    if cand.numel():
        err = _lib().bitmap_update_launch(
            cand.data_ptr(), visited.data_ptr(), new.data_ptr(),
            vout.data_ptr(), cnt.data_ptr(), int(cand.numel()),
            stream_ptr(dev))
        raise_on_error(err, "bitmap_update")
        LAUNCHES["bitmap_update"] += 1
    return new, vout, cnt


def bitmap_update_batch(cand: torch.Tensor, visited: torch.Tensor):
    """Fused P3 on a stack of planes (K3).

    cand/visited: int32[g, w] packed words, planes-major.  Returns (new,
    visited_out, counts int32[g, 1, 1])."""
    if cand.device.type == "cpu":
        return ref.bitmap_update_batch_ref(cand, visited)
    dev = _checked_device(cand, visited, 2)
    g, w = cand.shape
    if g > _MAX_PLANES:
        raise ValueError(f"{g} planes exceed the kernel's {_MAX_PLANES}")
    new = torch.empty_like(cand)
    vout = torch.empty_like(visited)
    cnt = torch.zeros((g, 1, 1), dtype=torch.int32, device=dev)
    if cand.numel():
        err = _lib().bitmap_update_batch_launch(
            cand.data_ptr(), visited.data_ptr(), new.data_ptr(),
            vout.data_ptr(), cnt.data_ptr(), int(g), int(w), stream_ptr(dev))
        raise_on_error(err, "bitmap_update_batch")
        LAUNCHES["bitmap_update_batch"] += 1
    return new, vout, cnt
