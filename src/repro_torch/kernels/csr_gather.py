"""Launch wrapper of the paged CSR gather kernel (the HBM reader).

Port of ``repro.kernels.csr_gather``.  One kernel, hand-written in CUDA
C++ for Hopper (``csrc/csr_gather.cu``, whose header note gives its bound
and design):

* ``gather_pages`` (K5) — ``out[i] = edges_paged[page_ids[i]]``, one
  fixed-size page of the edge array per work item.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a CUDA
tensor launches the kernel or raises.  The wrapper counts its launches in
``LAUNCHES`` and reports each call to the step analysis counting, if any,
at :func:`gather_bytes`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"gather_pages": 0}

_LIB = "csr_gather"
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.gather_pages_launch
        f.argtypes = [p, p, p, ll, ll, i, p]
        f.restype = i
        _bound = True
    return lib


def gather_bytes(edges_paged: torch.Tensor, page_ids: torch.Tensor) -> int:
    """K5's bytes on these inputs: each distinct page the ids reach read
    once (short lists share pages), each item's page written, and the
    ids.  Reads the ids back to the host."""
    n, page = edges_paged.shape
    ids = page_ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    m, distinct = ids.numel(), int(torch.unique(ids).numel())
    return (distinct + m) * page * edges_paged.element_size() + m * 4


def gather_pages(edges_paged: torch.Tensor,
                 page_ids: torch.Tensor) -> torch.Tensor:
    """Gather pages of the edge array: ``out[i] = edges_paged[page_ids[i]]``
    (K5).

    edges_paged: int32[num_pages, page] (the edge array viewed as pages).
    page_ids: int32[m] (the page table).  An id outside ``[0, num_pages)``
    is wrapped once if negative, then clamped, as the reference's jnp
    indexing does.  Returns int32[m, page]."""
    if edges_paged.dim() != 2 or edges_paged.shape[0] == 0:
        raise ValueError(f"edges_paged must be [num_pages >= 1, page], got "
                         f"{tuple(edges_paged.shape)}")
    if _report.active is not None:
        return _report.active.kernel_call(
            "gather_pages", lambda: (gather_bytes(edges_paged, page_ids),
                                     0.0),
            gather_pages, edges_paged, page_ids)
    if edges_paged.device.type == "cpu":
        return ref.gather_pages_ref(edges_paged, page_ids)
    dev = edges_paged.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("edges_paged", edges_paged, torch.int32, 2, dev)
    check_arg("page_ids", page_ids, torch.int32, 1, dev)
    num_pages, page = edges_paged.shape
    m = page_ids.shape[0]
    out = torch.empty((m, page), dtype=torch.int32, device=dev)
    if m and page:
        err = _lib().gather_pages_launch(
            edges_paged.data_ptr(), page_ids.data_ptr(), out.data_ptr(),
            int(num_pages), int(m), int(page), stream_ptr(dev))
        raise_on_error(err, "gather_pages")
        LAUNCHES["gather_pages"] += 1
    return out
