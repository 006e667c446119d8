"""Vertex dispatcher — the paper's crossbar, as collectives (§IV-D); the
PyTorch port of ``repro.core.dispatcher``.

The FPGA dispatcher routes neighbor-vertex messages to owning PEs through
either a full N×N crossbar (N² FIFOs) or a k-layer crossbar
(N = C1×…×Ck, Σ (N/Ci)·Ci² FIFOs).  Over a ``torch.distributed`` device
mesh the same two designs are:

* ``flat``   — one ``all_to_all_single`` over the group of the *flattened*
  mesh axes: every rank exchanges with all Q peers directly.  This is the
  full crossbar.
* ``staged`` — one exchange per mesh axis, most significant first, on
  that axis's group, with a local OR between stages: the multi-layer
  crossbar with C_i = axis size.

The OR is local: each exchange is an all-to-all and the receiver ORs what
it got over the senders, so no collective reduces with a bitwise OR
(NCCL has none).  Functions take process groups where the reference
takes axis names (``launch.mesh.axes_group`` builds them).

Two message representations:

* bitmap  — candidates as a packed bitmap over the global (reindexed)
  vertex space; combining = bitwise OR (subsumes the paper's conflict
  recombiner).  Delivery is an OR-reduce-scatter.
* queue   — capacity-bounded vertex-ID buckets (the literal FIFO design),
  with overflow carried to a retry round.

Plane words are int32 tensors holding the reference's uint32 bits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import bitmap


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row i of ``x`` [size, ...] goes to rank i of ``group``; row j of the
    result came from rank j (the reference's untiled all_to_all)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise-OR reduction over axis 0."""
    acc = x[0]
    for row in x[1:]:
        acc = acc | row
    return acc


# ---------------------------------------------------------------------------
# Bitmap dispatch: OR-reduce-scatter, flat or staged.
# ---------------------------------------------------------------------------

def or_reduce_scatter_flat(cand_words: torch.Tensor, group,
                           num_shards: int) -> torch.Tensor:
    """Full-crossbar delivery: one all-to-all over the flattened group.

    cand_words: int32[W] candidate bitmap over the global vertex space.
    Returns int32[W / Q]: the OR over all shards of this shard's region.
    """
    w = cand_words.shape[0]
    x = cand_words.reshape(num_shards, w // num_shards)
    return _or_reduce(_all_to_all(x, group))


def or_reduce_scatter_staged(cand_words: torch.Tensor, groups,
                             axis_sizes: tuple[int, ...]) -> torch.Tensor:
    """Multi-layer-crossbar delivery: per-axis exchange + OR between layers.

    ``groups`` are the axes' groups, most-significant first in the
    flattened shard index (shard = ((pod*D)+data)*M + model), matching
    contiguous region ownership.
    """
    cur = cand_words
    for group, size in zip(groups, axis_sizes):
        w = cur.shape[0]
        cur = _or_reduce(_all_to_all(cur.reshape(size, w // size), group))
    return cur


# ---------------------------------------------------------------------------
# Queue dispatch: capacity-bounded vertex-ID all-to-all (literal FIFOs).
# ---------------------------------------------------------------------------

def queue_dispatch(nbr_ids: torch.Tensor, group, num_shards: int,
                   verts_per_shard: int, capacity: int):
    """Route vertex IDs to their owning shards with per-destination capacity.

    nbr_ids: int32[B] global reindexed vertex IDs, -1 = empty slot.
    Returns (received int32[Q*capacity] global IDs with -1 pad,
             leftover int32[B] IDs that overflowed this round's FIFOs).
    The stable sort keeps the reference's FIFO order, so the same IDs fit
    and the same are left over.
    """
    dev = nbr_ids.device
    b = nbr_ids.shape[0]
    owner = torch.where(nbr_ids >= 0,
                        torch.div(nbr_ids, verts_per_shard,
                                  rounding_mode="floor"),
                        num_shards).to(torch.int64)
    order = torch.argsort(owner, stable=True)       # invalid last
    ids_sorted = nbr_ids[order]
    owner_sorted = owner[order]
    group_start = torch.searchsorted(
        owner_sorted, torch.arange(num_shards + 1, device=dev), right=False)
    rank = torch.arange(b, device=dev) - group_start[
        owner_sorted.clamp(max=num_shards)]
    fits = (owner_sorted < num_shards) & (rank < capacity)
    slot = torch.where(fits, owner_sorted * capacity + rank,
                       num_shards * capacity)
    send = torch.full((num_shards * capacity + 1,), -1, dtype=torch.int32,
                      device=dev)
    minus1 = torch.tensor(-1, dtype=nbr_ids.dtype, device=dev)
    send[slot] = torch.where(fits, ids_sorted, minus1).to(torch.int32)
    recv = _all_to_all(send[:-1].reshape(num_shards, capacity), group)
    leftover = torch.where(fits | (owner_sorted >= num_shards), minus1,
                           ids_sorted)
    return recv.reshape(-1), leftover


def received_to_local_bits(recv_ids: torch.Tensor, shard_index: int,
                           verts_per_shard: int) -> torch.Tensor:
    """Convert received global IDs into this shard's local candidate bitmap."""
    local = recv_ids - shard_index * verts_per_shard
    local = torch.where(recv_ids >= 0, local, -1)
    return bitmap.from_indices_dense(local, verts_per_shard)
