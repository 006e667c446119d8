"""Launch wrapper of the frontier expansion kernels.

Replaces no TPU kernel: the reference compacts and expands a level with
jnp (``repro.core.bfs_local.compact_indices`` / ``expand_edges``).  One
entry, hand-written in CUDA C++ for Hopper (``csrc/expand_frontier.cu``,
whose header note gives its bound and design), computes

    expand_edges(compact_indices(mask, mask.numel())[0], indptr, indices,
                 budget)

slot for slot: the lists of the vertices set in ``mask``, ascending, then
in list order, flattened into ``budget`` slots (int32 src and nbr, -1 at
and after the edge total; bool valid) and the total as a device int32
scalar, which may exceed ``budget``.  Five launches on the current stream
and no host sync: a scan over the vertices writes each owner's degree
prefix and the total on the device, then a merge-path pass over the slots
writes the three outputs.

The engines' one entry for a level's expansion (every one-card step calls
it).  A tensor on the CPU goes to the plain version,
``kernels.ref.expand_frontier_ref``, which is those two functions; a CUDA
tensor launches the kernels or raises.  ``LAUNCHES`` counts the calls that
reach the card; each call, on either device, reports to the step analysis
counting, if any, at the bytes of :func:`expand_traffic`, so a wave counts
alike on both.  The launch refuses outputs not aligned to its 16- and
4-byte stores (``torch.empty`` aligns them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"expand_frontier": 0}

_LIB = "expand_frontier"
SCAN_TILE = 2048              # vertices a block of the vertex pass
SLOT_TILE = 1024              # slots a tile of the slot pass
# the C launch function's passes (``phases``): 1 the vertex scan, 2 the
# slots; PHASES_ALL runs both
PHASES_ALL = 0x3
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = lib.expand_frontier_launch
        f.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, ll, i, p]
        f.restype = i
        _bound = True
    return lib


def expand_traffic(mask: torch.Tensor, indptr: torch.Tensor,
                   budget: int) -> int:
    """The expansion's bytes on these inputs, each input read once and
    each output written once: the mask, indptr (n + 1 entries), the
    neighbour id of each edge slot below the budget, the three outputs
    (4 + 4 + 1 bytes a slot) and the total.  Reads the data back to the
    host."""
    n = int(mask.numel())
    deg = (indptr[1:n + 1] - indptr[:n]).to(torch.int64)
    total = int(deg[mask].sum())
    return n + 4 * (n + 1) + 4 * min(total, budget) + 9 * budget + 4


def check_args(mask: torch.Tensor, indptr: torch.Tensor,
               indices: torch.Tensor, budget: int) -> None:
    """Raise unless the inputs are what the kernels read: a contiguous
    bool[n] mask, int32 indptr of at least n + 1 entries and int32 indices
    on the mask's CUDA device, and a budget of at least 0."""
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_arg("mask", mask, torch.bool, 1, dev)
    check_arg("indptr", indptr, torch.int32, 1, dev)
    check_arg("indices", indices, torch.int32, 1, dev)
    if indptr.shape[0] < mask.shape[0] + 1:
        raise ValueError(f"indptr {tuple(indptr.shape)} must hold "
                         f"{mask.shape[0] + 1} entries for mask "
                         f"{tuple(mask.shape)}")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")


def expand_frontier(mask: torch.Tensor, indptr: torch.Tensor,
                    indices: torch.Tensor, budget: int):
    """P1 compaction + P2 expansion of ``mask``'s vertices into ``budget``
    slots.  Returns (src int32[budget], nbr int32[budget], valid
    bool[budget], total int32 scalar), equal to the plain
    ``compact_indices`` + ``expand_edges``."""
    budget = int(budget)
    if _report.active is not None:
        return _report.active.kernel_call(
            "expand_frontier", lambda: (expand_traffic(mask, indptr, budget),
                                        0.0),
            expand_frontier, mask, indptr, indices, budget)
    if mask.device.type == "cpu":
        return ref.expand_frontier_ref(mask, indptr, indices, budget)
    check_args(mask, indptr, indices, budget)
    bufs = buffers(mask, budget)
    raise_on_error(launch(mask, indptr, indices, budget, bufs),
                   "expand_frontier")
    LAUNCHES["expand_frontier"] += 1
    return bufs["src"], bufs["nbr"], bufs["valid"], bufs["scalars"][0]


def buffers(mask: torch.Tensor, budget: int) -> dict:
    """A launch's scratch and outputs, on the mask's device: ``tiles``
    (each vertex tile's owner count, then its degree sum), ``info`` and
    ``cum`` (an owner's vertex and list offset, its degree prefix),
    ``part`` (each slot tile's first owner), ``scalars`` (the total, the
    owner count), and the outputs ``src``, ``nbr``, ``valid``."""
    n = int(mask.shape[0])
    i32 = dict(dtype=torch.int32, device=mask.device)
    return dict(
        tiles=torch.empty(2 * -(-n // SCAN_TILE), **i32),
        info=torch.empty(2 * n, **i32), cum=torch.empty(n, **i32),
        part=torch.empty(-(-budget // SLOT_TILE) + 1, **i32),
        scalars=torch.empty(2, **i32), src=torch.empty(budget, **i32),
        nbr=torch.empty(budget, **i32),
        valid=torch.empty(budget, dtype=torch.bool, device=mask.device))


def launch(mask: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
           budget: int, bufs: dict, phases: int = PHASES_ALL) -> int:
    """The C launch on checked inputs and :func:`buffers`' tensors: the
    passes in ``phases`` (one alone reads what an earlier launch left in
    ``bufs``).  Returns the launch's CUDA error code."""
    n = int(mask.shape[0])
    tiles = bufs["tiles"]
    return _lib().expand_frontier_launch(
        mask.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        tiles.data_ptr(), tiles[tiles.shape[0] // 2:].data_ptr(),
        bufs["cum"].data_ptr(), bufs["info"].data_ptr(),
        bufs["part"].data_ptr(), bufs["scalars"].data_ptr(),
        bufs["src"].data_ptr(), bufs["nbr"].data_ptr(),
        bufs["valid"].data_ptr(), n, int(budget), phases,
        stream_ptr(mask.device))
