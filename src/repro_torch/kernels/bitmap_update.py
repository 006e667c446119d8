"""Launch wrappers of the fused P3 bitmap-update kernels.

Port of ``repro.kernels.bitmap_update``.  Hand-written in CUDA C++ for
Hopper (``csrc/bitmap_update.cu``, whose header note gives their bound and
design), all computing ``new = cand & ~visited``, ``visited | new`` and the
popcount of ``new``, each kernel writing its counts itself (no zero fill):

* ``bitmap_update`` (K4) — one flat frontier of int32[w] words, one count;
  the single-source ``BFSRunner``'s P3, into ``out=`` buffers the runner
  keeps.
* ``bitmap_update_rows`` (K3 on the engine's planes) — int32[n, nw], a row
  per vertex and plane j in column j, one count per column; the bool-plane
  baseline's P3, on its words as they are (no transposes).
* ``bitmap_update_batch`` (K3 as the TPU kernel takes it) — a planes-major
  stack int32[g, w], one count per plane.

The two forms of K3 count their launches under the one key
``"bitmap_update_batch"`` and report to the step analysis under it.  The
TPU kernels took ``[rows, 128]`` word tiles padded to whole row blocks;
these take any ``w`` as it is.  A tensor on the CPU goes to the plain
version in ``kernels.ref``; a CUDA tensor launches the kernel or raises.
Each wrapper counts its launches in ``LAUNCHES`` and reports each call to
the step analysis counting, if any, at :func:`p3_bytes`.  Outputs are fresh
tensors, or K4's ``out=`` buffers, which may not overlap its inputs: the
engines retry an overflowed level from its pre-step state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error

LAUNCHES = {"bitmap_update": 0, "bitmap_update_batch": 0}

_LIB = "bitmap_update"
_MAX_PLANES = 65535          # the planes-major grid's y extent
_MAX_COLS = 12288            # the rows kernel's column sums: 48 KB of smem
# the arrival counter and an accumulator a count, for up to 256 counts; a
# launch with more asks for more
_SCRATCH_WORDS = 1 + 256
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
        f.argtypes = [p, p, p, p, p, p, ll, i, ll, p]
        f.restype = i
        f = lib.bitmap_update_rows_launch
        f.argtypes = [p, p, p, p, p, p, ll, ll, i, p]
        f.restype = i
        _bound = True
    return lib


def scratch_for(dev: torch.device, stream: int | None = None,
                words: int = _SCRATCH_WORDS) -> torch.Tensor:
    """The P3 kernels' scratch for one stream of ``dev`` (its handle;
    None: the current stream), at least ``words`` int32 (an arrival
    counter, then an accumulator a count): zeroed when made and left zero
    by every launch, so the launches of one stream share it.  A launch
    that needs more replaces it with a larger one, zeroed, on that
    stream."""
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    buf = _scratch.get((dev.index, stream))
    if buf is None or buf.numel() < words:
        buf = _scratch[(dev.index, stream)] = torch.zeros(
            max(words, _SCRATCH_WORDS), dtype=torch.int32, device=dev)
    return buf


def p3_bytes(cand: torch.Tensor, rows: bool = False) -> int:
    """K3's or K4's bytes: cand and visited read, new and visited_out
    written, and one int32 count a plane: one (K4, int32[w]), g (K3
    planes-major, int32[g, w]) or nw (K3 on the engine's rows, int32[n,
    nw], ``rows=True``)."""
    if cand.dim() == 1:
        planes = 1
    else:
        planes = cand.shape[1] if rows else cand.shape[0]
    return 4 * cand.numel() * 4 + 4 * planes


def _check_pair(cand: torch.Tensor, visited: torch.Tensor,
                ndim: int) -> None:
    check_arg("cand", cand, torch.int32, ndim, cand.device)
    check_arg("visited", visited, torch.int32, ndim, cand.device)
    if cand.shape != visited.shape:
        raise ValueError(f"shape mismatch: cand {tuple(cand.shape)} visited "
                         f"{tuple(visited.shape)}")


def _checked_device(cand: torch.Tensor, visited: torch.Tensor,
                    ndim: int) -> torch.device:
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_pair(cand, visited, ndim)
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


def bitmap_update_rows(cand: torch.Tensor, visited: torch.Tensor):
    """Fused P3 on the engine's planes as it holds them (K3, rows form).

    cand/visited: contiguous int32[n, nw] packed words, a row per vertex
    and plane j in column j (a non-contiguous input raises: it is never
    copied).  Returns fresh (new, visited_out int32[n, nw], counts int32[nw,
    1, 1]), ``counts[j]`` the popcount of column j of new: what
    :func:`bitmap_update_batch` gives on ``cand.T, visited.T``, outputs
    transposed back.  One launch a call on the card, counted under
    ``LAUNCHES["bitmap_update_batch"]``."""
    if _report.active is not None:
        return _report.active.kernel_call(
            "bitmap_update_batch", lambda: (p3_bytes(cand, rows=True), 0.0),
            bitmap_update_rows, cand, visited)
    _check_pair(cand, visited, 2)
    dev = cand.device
    if dev.type == "cpu":
        return ref.bitmap_update_rows_ref(cand, visited)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, nw = cand.shape
    if nw > _MAX_COLS:
        raise ValueError(f"{nw} columns exceed the kernel's {_MAX_COLS}")
    new = torch.empty_like(cand)
    vout = torch.empty_like(visited)
    cnt = torch.empty((nw, 1, 1), dtype=torch.int32, device=dev)
    if nw:
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = scratch_for(dev, stream, 1 + nw)
        err = _lib().bitmap_update_rows_launch(
            cand.data_ptr(), visited.data_ptr(), new.data_ptr(),
            vout.data_ptr(), cnt.data_ptr(), scratch.data_ptr(),
            scratch.numel(), int(n), int(nw), stream)
        raise_on_error(err, "bitmap_update_rows")
        LAUNCHES["bitmap_update_batch"] += 1
    return new, vout, cnt


def bitmap_update_batch(cand: torch.Tensor, visited: torch.Tensor):
    """Fused P3 on a stack of planes (K3, the TPU kernel's form).

    cand/visited: int32[g, w] packed words, planes-major.  Returns (new,
    visited_out, counts int32[g, 1, 1]), one launch a call on the card."""
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
    cnt = torch.empty((g, 1, 1), dtype=torch.int32, device=dev)
    if g:
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = scratch_for(dev, stream, 1 + g)
        err = _lib().bitmap_update_batch_launch(
            cand.data_ptr(), visited.data_ptr(), new.data_ptr(),
            vout.data_ptr(), cnt.data_ptr(), scratch.data_ptr(),
            scratch.numel(), int(g), int(w), stream)
        raise_on_error(err, "bitmap_update_batch")
        LAUNCHES["bitmap_update_batch"] += 1
    return new, vout, cnt
