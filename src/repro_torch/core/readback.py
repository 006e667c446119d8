"""Reused page-locked host memory for the engines' final readback.

A device-to-host copy into pageable memory is staged by CUDA through a
small page-locked buffer of its own; into page-locked memory it is one
DMA at the host link's rate (a 1-GiB copy on an H100: 430 ms pageable,
19.5 ms page-locked).  Locking memory is slow in itself (about 0.6 s a
GiB), so a ``PinnedPool`` keeps its blocks and reuses them.

Ownership: ``fetch`` returns an ndarray whose base is a lease on one
block.  Every view of that array, and every tensor ``torch.from_numpy``
makes of it, keeps the lease alive; the pool holds the lease weakly, and
hands the block out again only once the lease is gone.  So an answer the
caller still holds is never overwritten.

Growth: a block is made only when no free block is large enough, exactly
as large as the payload; the free blocks, all smaller, are released then.
So the pool never holds more blocks than the most answers alive at once.

The pool engages on tensors of ``device_type`` (the card): for any other
tensor ``admit`` counts nothing and ``fetch`` is the plain ``.cpu()``, so a
CPU graph reads back as it always did.  One thread at a time uses a pool,
as it uses the runner that owns it.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

_HOST_REGISTER_PORTABLE = 1     # cudaHostRegisterPortable


class _Lease:
    """The base object of a fetched array: keeps its block alive."""

    __slots__ = ("block", "__array_interface__", "__weakref__")

    def __init__(self, block: torch.Tensor, interface: dict):
        self.block = block
        self.__array_interface__ = interface


class _Slot:
    """One block of the pool and the weak reference to its lease."""

    __slots__ = ("nbytes", "block", "lease", "taken")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.block: torch.Tensor | None = None   # made by the first fetch
        self.lease = None                        # weakref to the _Lease
        self.taken = False                       # admitted, not yet leased

    @property
    def free(self) -> bool:
        return not self.taken and (self.lease is None
                                   or self.lease() is None)


class PinnedPool:
    """Page-locked host blocks for one runner's readbacks, reused once no
    result refers to them.  ``readbacks`` counts the admitted readbacks,
    ``grown`` those that had to add a block.

    ``admit(t)`` marks ``t`` as a readback and picks (and counts) the
    block that ``fetch(t)`` then fills, so a span opened between the two
    carries the counts of this very readback.  ``fetch`` of a tensor not
    admitted (a statvec) is the plain ``.cpu()``.
    """

    device_type = "cuda"

    def __init__(self):
        self._slots: list[_Slot] = []
        self._next: tuple[_Slot, torch.Tensor] | None = None
        self.readbacks = 0
        self.grown = 0

    @staticmethod
    def alloc(nbytes: int) -> torch.Tensor:
        """``nbytes`` of host memory page-locked for the card: an ordinary
        host tensor registered with CUDA, unregistered when collected."""
        block = torch.empty(nbytes, dtype=torch.uint8)
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(block.data_ptr(), nbytes,
                                      _HOST_REGISTER_PORTABLE)
        if err != cudart.cudaError.success:
            raise RuntimeError(
                f"cudaHostRegister of {nbytes} bytes failed: {err}")
        weakref.finalize(block, cudart.cudaHostUnregister, block.data_ptr())
        return block

    def admit(self, t: torch.Tensor) -> dict | None:
        """Choose the block for ``t``'s fetch: the smallest free one that
        holds it, else a new one.  Returns ``stats()`` with it counted
        (None where the pool does not engage)."""
        if t.device.type != self.device_type:
            return None
        if self._next is not None:      # admitted, never fetched
            self._next[0].taken = False
        nbytes = t.numel() * t.element_size()
        fit = [s for s in self._slots if s.free and s.nbytes >= nbytes]
        if fit:
            slot = min(fit, key=lambda s: s.nbytes)
        else:
            # every free block is too small for this payload: release them
            self._slots = [s for s in self._slots if not s.free]
            slot = _Slot(nbytes)
            self._slots.append(slot)
            self.grown += 1
        slot.taken = True
        self._next = (slot, t)
        self.readbacks += 1
        return self.stats()

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as an ndarray of its dtype and shape, C-contiguous: an
        admitted ``t`` copied into its block (one copy, one stream sync),
        any other by ``.cpu()``."""
        if self._next is None or self._next[1] is not t:
            return t.cpu().numpy()
        slot, self._next = self._next[0], None
        slot.taken = False              # free again if the copy fails
        nbytes = t.numel() * t.element_size()
        if slot.block is None:
            slot.block = self.alloc(slot.nbytes)
        host = slot.block[:nbytes].view(t.dtype).view(t.shape)
        host.copy_(t)
        lease = _Lease(slot.block, host.numpy().__array_interface__)
        slot.lease = weakref.ref(lease)
        return np.asarray(lease)

    def stats(self) -> dict:
        """The counts: readbacks, those that grew the pool, its blocks and
        their bytes, and the share of readbacks that reused a block."""
        return dict(
            readbacks=self.readbacks, grown=self.grown,
            blocks=len(self._slots),
            pinned_bytes=sum(s.nbytes for s in self._slots
                             if s.block is not None),
            reuse_share=(1.0 - self.grown / self.readbacks
                         if self.readbacks else None))
