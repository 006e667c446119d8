"""Launch wrappers of the fused P3 bitmap-update kernels.

Port of ``repro.kernels.bitmap_update``.  Two kernels, hand-written in CUDA
C++ for Hopper (``csrc/bitmap_update.cu``, whose header note gives their
bound and design), both computing ``new = cand & ~visited``, ``visited |
new`` and the popcount of ``new``:

* ``bitmap_update`` (K4) — one flat frontier of int32[w] words, one count
  the kernel writes itself (no zero fill); the single-source
  ``BFSRunner``'s P3, into ``out=`` buffers the runner keeps.
* ``bitmap_update_batch`` (K3) — a planes-major stack int32[g, w], one
  count per plane; the bool-plane baseline's P3.

The TPU kernels took ``[rows, 128]`` word tiles padded to whole row
blocks; these take any ``w`` as it is.  A tensor on the CPU goes to the
plain version in ``kernels.ref``; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``LAUNCHES`` and reports each
call to the step analysis counting, if any, at :func:`p3_bytes`.  Outputs are
fresh tensors, or K4's ``out=`` buffers, which may not overlap its inputs:
the engines retry an overflowed level from its pre-step state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"bitmap_update": 0, "bitmap_update_batch": 0}

_LIB = "bitmap_update"
_MAX_PLANES = 65535          # the grid's y extent
_SCRATCH_WORDS = 1 + 132 * 16    # K4's arrival counter + a partial a block
_bound = False
_scratch: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.bitmap_update_launch
        f.argtypes = [p, p, p, p, p, p, ll, p]
        f.restype = i
        f = lib.bitmap_update_batch_launch
        f.argtypes = [p, p, p, p, p, i, ll, p]
        f.restype = i
        _bound = True
    return lib


def scratch_for(dev: torch.device, stream: int | None = None
                ) -> torch.Tensor:
    """K4's scratch for one stream of ``dev`` (its handle; None: the
    current stream): zeroed once, left zero by every launch, so the
    launches of one stream share it."""
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    buf = _scratch.get((dev.index, stream))
    if buf is None:
        buf = _scratch[(dev.index, stream)] = torch.zeros(
            _SCRATCH_WORDS, dtype=torch.int32, device=dev)
    return buf


def p3_bytes(cand: torch.Tensor) -> int:
    """K3's or K4's bytes: cand and visited read, new and visited_out
    written, and one int32 count a plane (K3, int32[g, w]) or one (K4)."""
    return 4 * cand.numel() * 4 + 4 * (cand.shape[0] if cand.dim() == 2
                                       else 1)


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


def _check_out(cand: torch.Tensor, visited: torch.Tensor, out) -> tuple:
    """``out`` = (new, visited_out, count): int32, contiguous, on cand's
    device, new and visited_out shaped like cand, count [1, 1], and no
    output overlapping an input or another output.  Returns the five
    data pointers (cand, visited, new, visited_out, count)."""
    if len(out) != 3:
        raise ValueError(f"out must be (new, visited_out, count), got "
                         f"{len(out)} tensors")
    for name, t, shape in zip(("new", "visited_out", "count"), out,
                              (cand.shape, cand.shape, (1, 1))):
        if (t.dtype != torch.int32 or t.shape != shape
                or t.device != cand.device or not t.is_contiguous()):
            raise ValueError(f"out {name} must be a contiguous int32 "
                             f"{tuple(shape)} on {cand.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ptrs = (cand.data_ptr(), visited.data_ptr(),
            *(t.data_ptr() for t in out))
    nbytes = 4 * cand.numel()
    ends = [p + n for p, n in zip(ptrs, (nbytes,) * 4 + (4,))]
    if nbytes:
        for i in range(2, 5):               # each output against the rest
            for j in range(i):
                if ptrs[i] < ends[j] and ptrs[j] < ends[i]:
                    raise ValueError("out buffers may not overlap the "
                                     "inputs or each other")
    return ptrs


def bitmap_update(cand: torch.Tensor, visited: torch.Tensor, out=None):
    """Fused P3 on one frontier (K4).

    cand/visited: int32[w] packed words.  ``out``: optional (new,
    visited_out, count int32[1, 1]) to write, none overlapping another or
    an input.  Returns (new, visited_out, count int32[1, 1]): ``out`` when
    given, else fresh tensors."""
    if _report.active is not None:
        return _report.active.kernel_call(
            "bitmap_update", lambda: (p3_bytes(cand), 0.0), bitmap_update,
            cand, visited, out)
    if cand.device.type == "cpu":
        if out is not None:
            _check_out(cand, visited, out)
        res = ref.bitmap_update_ref(cand, visited)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    dev = _checked_device(cand, visited, 1)
    if out is None:
        out = (torch.empty_like(cand), torch.empty_like(visited),
               torch.empty((1, 1), dtype=torch.int32, device=dev))
    ptrs = _check_out(cand, visited, out)
    w = cand.numel()
    if w == 0:
        out[2].zero_()
        return tuple(out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().bitmap_update_launch(
        *ptrs, scratch_for(dev, stream).data_ptr(), w, stream)
    raise_on_error(err, "bitmap_update")
    LAUNCHES["bitmap_update"] += 1
    return tuple(out)


def bitmap_update_batch(cand: torch.Tensor, visited: torch.Tensor):
    """Fused P3 on a stack of planes (K3).

    cand/visited: int32[g, w] packed words, planes-major.  Returns (new,
    visited_out, counts int32[g, 1, 1])."""
    if _report.active is not None:
        return _report.active.kernel_call(
            "bitmap_update_batch", lambda: (p3_bytes(cand), 0.0),
            bitmap_update_batch, cand, visited)
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
