"""Packed-bitmap plane state (paper Algorithm 2), PyTorch port of
``repro.core.bitmap``.

Plane words are stored as **int32 tensors holding the same bits** as the
reference's uint32 words: PyTorch on the CPU has no ``~`` or ``>>`` on
uint32.  Three consequences run through this module:

* ``>>`` on int32 is arithmetic (it copies the sign bit), so every shift
  is followed by a mask before its bits are used;
* bit 31 is the sign bit, so a packed word with plane 31 set is negative;
* an unsigned comparison (the "max" combine) is a signed comparison after
  flipping bit 31 (``x ^ INT32_MIN``).

Out-of-range rows never wrap: where the reference relies on JAX's
``mode="drop"``, this module scatters into an explicit trash row that is
sliced off afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
INT32_MIN = -(1 << 31)


def num_words(num_bits: int) -> int:
    return (num_bits + WORD_BITS - 1) // WORD_BITS


def _bit_values(device) -> torch.Tensor:
    """int32[32]: 1 << b for every bit b (bit 31 is INT32_MIN)."""
    one = torch.ones(WORD_BITS, dtype=torch.int32, device=device)
    return one << torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_rows(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., B] -> int32[..., num_words(B)] (little-endian bit order).

    The sum of distinct bit values never overflows int32: bits 0..30 add up
    to at most 2**31 - 1 and bit 31 contributes -2**31."""
    nb = mask.shape[-1]
    pad = (-nb) % WORD_BITS
    m = torch.nn.functional.pad(mask.to(torch.int32), (0, pad))
    m = m.reshape(*mask.shape[:-1], -1, WORD_BITS)
    return (m * _bit_values(mask.device)).sum(-1, dtype=torch.int32)


def unpack_rows(words: torch.Tensor, num_bits: int | None = None
                ) -> torch.Tensor:
    """int32[..., nw] -> bool[..., num_bits]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> shifts) & 1).to(torch.bool)
    flat = bits.reshape(*words.shape[:-1], -1)
    return flat if num_bits is None else flat[..., :num_bits]


def pack(mask: torch.Tensor) -> torch.Tensor:
    """bool[num_bits] -> int32[num_words]."""
    return pack_rows(mask)


def unpack(words: torch.Tensor, num_bits: int | None = None) -> torch.Tensor:
    """int32[num_words] -> bool[num_bits]."""
    return unpack_rows(words, num_bits)


def plane_mask(num_bits: int, device=None) -> torch.Tensor:
    """int32[num_words] with the first ``num_bits`` bits set — masks the
    pad bits of the last source word (needed before complementing)."""
    bits = torch.arange(num_words(num_bits) * WORD_BITS,
                        device=device) < num_bits
    return pack(bits)


def zeros(num_bits: int, device=None) -> torch.Tensor:
    return torch.zeros(num_words(num_bits), dtype=torch.int32, device=device)


def from_indices(idx: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Bitmap with bits ``idx`` set.  Out-of-range indices are ignored."""
    idx = torch.as_tensor(idx).to(torch.int64)
    nw = num_words(num_bits)
    valid = (idx >= 0) & (idx < num_bits)
    word = torch.where(valid, idx // WORD_BITS, nw)
    bit = torch.where(valid, _bit_values(idx.device)[idx % WORD_BITS], 0)
    out = torch.zeros(nw + 1, dtype=torch.int32, device=idx.device)
    return _scatter_or(out, word, bit)[:-1]


def _scatter_or(words: torch.Tensor, word_idx: torch.Tensor,
                bits: torch.Tensor) -> torch.Tensor:
    """Scatter bitwise-OR on flat words: ``words[word_idx] |= bits``
    (duplicates allowed, out-of-range word indices dropped); the row form
    :func:`_scatter_or_rows` with one word per row."""
    return _scatter_or_rows(words[:, None], word_idx,
                            bits.to(torch.int32)[:, None])[:, 0]


def from_indices_dense(idx: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Bitmap from indices via a dense boolean intermediate.  Indices
    outside ``[0, num_bits)`` (the engine's ``-1`` pad slots) land in a
    trash slot, as JAX's ``mode="drop"`` drops them."""
    idx = torch.as_tensor(idx)
    dense = torch.zeros(num_bits + 1, dtype=torch.bool, device=idx.device)
    dense[drop_index(idx, num_bits)] = True
    return pack(dense[:num_bits])


def test_bits(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathered bit test: bool per index.  The shift is arithmetic on
    int32, so the ``& 1`` keeps only the tested bit, as the reference's
    unsigned shift does."""
    idx = idx.to(torch.int64)
    w = words[idx // WORD_BITS]
    return ((w >> (idx % WORD_BITS).to(torch.int32)) & 1).to(torch.bool)


def np_unpack(words: np.ndarray, num_bits: int) -> np.ndarray:
    """Host unpack of int32 or uint32 words (the bits are the same)."""
    b = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                      bitorder="little")
    return b[:num_bits].astype(bool)


def _popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (SWAR; masks after each
    arithmetic shift so a set sign bit never leaks into the counts)."""
    x = words.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F      # each byte now holds 0..8
    return ((x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)
            + ((x >> 24) & 0xFF))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """int32 scalar: total set bits."""
    return _popcount_words(words).sum(dtype=torch.int32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """int32[...]: per-row popcount over the packed source words."""
    return _popcount_words(words).sum(-1, dtype=torch.int32)


def any_rows(words: torch.Tensor) -> torch.Tensor:
    """bool[...]: does row v have any source bit set?"""
    return (words != 0).any(-1)


def pad_plane_slots(roots: np.ndarray, fill: int | None = None,
                    word_bits: int = WORD_BITS) -> tuple[np.ndarray, int]:
    """Pad a 1-D slot array so its length fills whole plane words.

    Each slot is an independent bit-plane and duplicate roots are legal,
    so the pad slots repeat ``fill`` (default: the first root).  Pad-slot
    work stays inert: a duplicate plane never changes the union frontier.
    Callers slice results with :func:`slice_plane_rows` and account TEPS
    over the real requests only.  ``fill`` must be a non-negative integer;
    bounds against |V| are the engine's ``validate_roots`` job.  Returns
    ``(padded_roots, original_length)``.
    """
    roots = np.asarray(roots)
    if roots.ndim != 1 or roots.size == 0:
        raise ValueError(f"roots must be 1-D and non-empty, got shape "
                         f"{roots.shape}")
    if fill is not None:
        if isinstance(fill, bool) or not isinstance(fill, (int, np.integer)):
            raise TypeError(f"fill must be an integer vertex id, got "
                            f"{type(fill).__name__} ({fill!r})")
        if fill < 0:
            raise ValueError(f"fill must be non-negative, got {fill}")
    b = int(roots.size)
    pad = (-b) % word_bits
    if pad == 0:
        return roots, b
    fill_v = roots[0] if fill is None else fill
    return np.concatenate(
        [roots, np.full(pad, fill_v, dtype=roots.dtype)]), b


def slice_plane_rows(rows, b: int):
    """Drop the pad slots of :func:`pad_plane_slots` from a per-slot result
    (levels ``[B_padded, n]`` -> ``[b, n]``, or any leading-axis array)."""
    return rows[:b]


def drop_index(row_idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """int64 row indices with every out-of-range entry (negative or
    >= ``num_rows``) sent to the trash row ``num_rows``."""
    row_idx = row_idx.to(torch.int64)
    return torch.where((row_idx >= 0) & (row_idx < num_rows), row_idx,
                       num_rows)


_BYTE_BITS = [1 << b for b in range(8)]


def _to_byte_planes(w: torch.Tensor) -> torch.Tensor:
    """int32[k, nw] -> uint8[k, nw * 32]: one single-bit byte per bit, in
    the little-endian order of the reference's uint32 -> uint8 bitcast."""
    k, nw = w.shape
    shifts = torch.tensor(_BYTE_BITS, dtype=torch.uint8, device=w.device)
    b8 = w.contiguous().view(torch.uint8).reshape(k, nw * 4)
    return (b8[..., None] & shifts).reshape(k, nw * 32)


def _scatter_or_rows(words: torch.Tensor, row_idx: torch.Tensor,
                     msg: torch.Tensor) -> torch.Tensor:
    """Packed scatter-OR: ``words[row_idx[e]] |= msg[e]`` for every e.

    Duplicate target rows OR together and out-of-range rows (negative or
    >= r) are dropped.  ``scatter_reduce("amax")`` is only an OR for
    single-bit values, so the words are split into uint8 single-bit byte
    planes first (8 per byte lane), scattered with one amax call, and
    summed back into bytes.

    words: int32[r, nw]   accumulator (existing bits are kept)
    row_idx: int[m]       target row per message (OOR -> dropped)
    msg: int32[m, nw]     packed source-mask words to OR in
    Returns a new int32[r, nw]; ``words`` is not modified.
    """
    r, nw = words.shape
    idx = drop_index(row_idx, r)
    acc = _to_byte_planes(torch.cat(
        [words, torch.zeros((1, nw), dtype=words.dtype,
                            device=words.device)]))
    acc.scatter_reduce_(0, idx[:, None].expand(-1, nw * 32),
                        _to_byte_planes(msg), "amax")
    bytes_ = acc[:r].reshape(r, nw * 4, 8).sum(-1).to(torch.uint8)
    return bytes_.view(torch.int32).reshape(r, nw)


def segment_or_rows(msg: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Segmented OR over rows of packed words.

    ``msg`` is int32[E, nw] (one packed source-mask per edge), ``first``
    is bool[E] marking the first edge of each contiguous segment.  Returns
    int32[E, nw] where row e holds the OR of msg over e's WHOLE segment.
    The reference returns the inclusive prefix-OR scan instead; the two
    agree at the last slot of every segment, which is the only slot any
    caller reads.  PyTorch has no ``associative_scan``, so this is a
    scatter-OR keyed by the segment owner followed by one gather.
    """
    seg = torch.cumsum(first.to(torch.int64), 0)     # 0 before 1st segment
    num_seg = int(first.shape[0]) + 1
    tot = _scatter_or_rows(
        torch.zeros((num_seg, msg.shape[1]), dtype=msg.dtype,
                    device=msg.device), seg, msg)
    return tot[seg]
