"""Distributed BFS over a ``torch.distributed`` device mesh (paper §IV);
the PyTorch port of ``repro.core.bfs_distributed``.

One mesh rank == one Processing Group bound to one memory channel; each
rank hosts ``k`` Processing Elements (k = shards per rank), every PE
owning one contiguous (reindexed) vertex interval — level array +
visited/frontier bitmap shards live in the rank's device memory, neighbor
lists are read from that memory only (the paper's locality rule).  ``k``
is the paper's second scaling direction (PEs per PC, Fig. 10).

The reference drives every device from one process, each step a jitted
``shard_map`` over ``[k, ...]`` blocks.  Here every rank runs the same
Python driver over its own ``[k, ...]`` blocks (SPMD), and the
reference's collectives are ``torch.distributed`` calls on the mesh's
groups: ``psum`` is one ``all_reduce(SUM)`` of one int32 vector a step,
``all_gather(tiled=True)`` an all-gather, the crossbar
(``core.dispatcher``) all-to-alls with a local OR.  Every host decision
(direction, budget growth, the overflow retry, the queue drain, ``done``)
reads only all-reduced values, so the ranks never branch apart.

Iteration structure:

  push:  P1 compact local frontiers (per PE) -> P2 expand local CSR
         out-lists -> DISPATCH candidates to owners (crossbar analogue)
         -> P3 receiver filters visited, updates bitmaps + levels.
  pull:  all-gather the (bit-packed) current frontier
         -> P1 compact local unvisited -> P2 expand local CSC in-lists,
         test parent frontier bits -> P3 local update (no dispatch).

The batched pull runs through the row-tiled propagate kernel K2
(``kernels.ops.msbfs_propagate_msgs``) under ``use_kernels``; the push's
local scatter is the plain ``bitmap._scatter_or_rows``, as the
reference's is jnp.  Every rank returns the whole value rows (the
reference's one controller sees the whole array).  The reference's
``abstract()`` / ``abstract_inputs()`` exist only to lower its dry-run and
are not ported.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bitmap
from repro_torch.core.bfs_local import (INF, SV_MF, SV_MU, SV_NF, SV_NU,
                                        SV_OVERFLOW, SV_TOTAL,
                                        compact_indices, validate_roots)
from repro_torch.core.dispatcher import (or_reduce_scatter_flat,
                                         or_reduce_scatter_staged,
                                         queue_dispatch,
                                         received_to_local_bits)
from repro_torch.core.partition import PartitionedGraph, reindex
from repro_torch.core.scheduler import PUSH, SchedulerConfig, choose_mode_host
from repro_torch.core.vertex_program import BFS, VertexProgram
from repro_torch.launch.mesh import (axes_group, axis_size, flat_axis_index,
                                     mesh_device)


@dataclasses.dataclass
class DistConfig:
    """Engine options (the reference's, with ``use_pallas`` as
    ``use_kernels``).

    ``use_kernels``: the batched pull through the row-tiled propagate
    kernel K2 (``kernels.ops.msbfs_propagate_msgs``) instead of the plain
    scatter-OR.  None means the kernels iff the mesh is on CUDA; False on a
    CUDA mesh raises ``ValueError`` (the plain path is a CPU path only);
    True on the CPU runs K2's plain body.  Pull only: the push candidates
    must cross the OR-reduce-scatter crossbar BEFORE the visited filter, so
    their P3 cannot fuse into the local scatter.

    ``tile_rows``: K2's tile.  None tiles at the PE vertex interval
    (verts_per_shard, ``vl``) when its accumulator, ``vl * nw * 4`` bytes
    (``nw`` plane words a row), fits one block's shared memory
    (``kernels.msbfs_propagate.MAX_SMEM_PER_BLOCK``); otherwise at the
    largest multiple of 8 that divides ``vl`` and fits, so every tile
    still lies inside one PE's interval.  A batch so wide that no 8 rows
    fit raises ``ValueError``.  The rows and counts are the same whatever
    the tile (:func:`pull_tile_rows`).  A given ``tile_rows`` is used as
    it is.
    """

    dispatch: str = "bitmap"      # "bitmap" | "queue"
    crossbar: str = "staged"      # "staged" (multi-layer) | "flat" (full)
    edge_budget: int = 1 << 15    # per-shard expansion budget (auto-grows)
    queue_capacity: int = 1 << 12  # per-destination FIFO depth (queue mode)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    use_kernels: bool | None = None
    tile_rows: int | None = None


def pull_tile_rows(vl: int, nw: int, tile_rows: int | None = None) -> int:
    """K2's tile for the batched pull (the rule in :class:`DistConfig`)."""
    if tile_rows:
        return int(tile_rows)
    from repro_torch.kernels.msbfs_propagate import MAX_SMEM_PER_BLOCK
    fit = MAX_SMEM_PER_BLOCK // (4 * nw)          # rows one block holds
    if vl <= fit:
        return vl
    for t in range(fit // 8 * 8, 7, -8):
        if vl % t == 0:
            return t
    raise ValueError(f"no tile of a multiple of 8 rows dividing {vl} fits "
                     f"{MAX_SMEM_PER_BLOCK} B of shared memory at {nw} "
                     "plane words a row")


def _compact_rows(mask: torch.Tensor) -> torch.Tensor:
    """P1 per PE row: int32[k, c] indices of the set bits of each row of
    bool[k, c], padded with -1 (the reference's vmapped
    ``compact_indices``)."""
    k, c = mask.shape
    pos = torch.cumsum(mask.to(torch.int64), 1) - 1
    slot = torch.where(mask, pos, c)
    out = torch.full((k, c + 1), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(1, slot, torch.arange(c, dtype=torch.int32,
                                       device=mask.device).expand(k, c))
    return out[:, :c]


def _expand_rows(active: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, budget: int):
    """P2 per PE row (the reference's vmapped ``expand_edges``): each row
    flattens its own active vertices' lists into ``budget`` slots.
    Returns (src, nbr, valid, total): int32[k, budget] with -1 in invalid
    slots, bool[k, budget] and int32[k] (a row's total may exceed
    ``budget``: overflow)."""
    dev = active.device
    k, c = active.shape
    a = active.clamp(min=0).to(torch.int64)
    deg = ((indptr.gather(1, a + 1) - indptr.gather(1, a))
           * (active >= 0)).to(torch.int64)
    cum = torch.cumsum(deg, 1)
    total = cum[:, -1]
    e = torch.arange(budget, dtype=torch.int64, device=dev).expand(
        k, budget).contiguous()
    owner = torch.searchsorted(cum, e, right=True).clamp_(max=c - 1)
    start = cum.gather(1, owner) - deg.gather(1, owner)
    src = active.gather(1, owner)
    valid = e < total[:, None]
    eidx = indptr.gather(1, src.clamp(min=0).to(torch.int64)).to(
        torch.int64) + (e - start)
    nbr = indices.gather(1, torch.where(valid, eidx, 0))
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    return (torch.where(valid, src, minus1), torch.where(valid, nbr, minus1),
            valid, total.to(torch.int32))


def _i32(xs, device) -> list:
    return [torch.as_tensor(x, device=device).to(torch.int32).reshape(())
            for x in xs]


class DistributedBFS:
    """Vertex-program engine over ``mesh``: Q = d*k shards, k PEs per rank.

    Every rank of the mesh constructs it with the same arguments and makes
    the same calls; each holds only its own k shards on its device.  The
    batched path is program-parameterized (``run_program_batch``): the
    default ``program`` (BFS unless overridden at construction) keeps
    ``run_batch`` protocol-uniform, so one ``DistributedBFS(pg, mesh,
    program=CC)`` serves CC through the same ``BFSEngine`` surface.
    """

    def __init__(self, pg: PartitionedGraph, mesh,
                 axis_names: tuple[str, ...] | None = None,
                 cfg: DistConfig | None = None,
                 program: VertexProgram = BFS):
        self.pg = pg
        self.program = program
        self.mesh = mesh
        self.axes = tuple(axis_names or mesh.mesh_dim_names)
        self.axis_sizes = tuple(axis_size(mesh, a) for a in self.axes)
        self.cfg = cfg or DistConfig()
        q = pg.num_shards
        d = int(np.prod(self.axis_sizes))
        if q % d:
            raise ValueError(f"shards {q} not a multiple of mesh size {d}")
        self.d = d
        self.k = q // d          # shards (PEs) per rank (PC)
        self.q = q
        self.vl = pg.verts_per_shard          # local vertices per shard
        self.wl = self.vl // bitmap.WORD_BITS  # local bitmap words
        self.n_pad = pg.num_vertices_padded
        self.device = mesh_device(mesh)
        on_cuda = self.device.type == "cuda"
        use = self.cfg.use_kernels
        if on_cuda and use is not None and not use:
            raise ValueError("use_kernels=False is a CPU path only; a mesh "
                             "on CUDA runs the kernels")
        self.use_kernels = on_cuda if use is None else bool(use)
        # collectives: the flattened axes (psum, all_gather, the full
        # crossbar, queue FIFOs) and one group per axis (staged crossbar)
        self._group = axes_group(mesh, self.axes)
        self._axis_groups = tuple(mesh.get_group(a) for a in self.axes)
        self.sidx = flat_axis_index(mesh, self.axes)
        own = slice(self.sidx * self.k, (self.sidx + 1) * self.k)
        put = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x[own])).to(self.device)
        # this rank's k shards of the shard-stacked graph arrays
        self.out_indptr = put(pg.out_indptr.astype(np.int32))
        self.out_indices = put(pg.out_indices)
        self.in_indptr = put(pg.in_indptr.astype(np.int32))
        self.in_indices = put(pg.in_indices)
        # stored per-shard degrees: the per-level scheduler stats would
        # otherwise re-derive them every single iteration
        out_deg_r = np.diff(pg.out_indptr, axis=1)
        self._out_deg_dev = put(out_deg_r.astype(np.int32))
        self._in_deg_dev = put(np.diff(pg.in_indptr, axis=1).astype(np.int32))
        # reindexed position of every original vertex: the readback
        # gathers rows into the original order on the device
        orig = np.arange(pg.num_vertices)
        pos = reindex(orig, q, self.vl) if pg.scheme == "hash" else orig
        self._orig_pos = torch.from_numpy(pos).to(self.device)
        # original-order degrees for the engine protocol (per-wave TEPS)
        self._out_deg_np = out_deg_r.reshape(-1)[pos].astype(np.int64)
        self.last_stats: dict = {}
        self.last_level_seconds: list[float] = []

    @property
    def num_vertices(self) -> int:
        """|V| served (the :class:`repro_torch.core.BFSEngine` protocol)."""
        return int(self.pg.num_vertices)

    @property
    def out_deg(self) -> np.ndarray:
        """Original-order out-degrees [n] (engine protocol)."""
        return self._out_deg_np

    # -- collectives --------------------------------------------------------
    def _psum(self, *xs) -> np.ndarray:
        """One all-reduce(SUM) of the int32 scalars ``xs``, fetched: the
        replicated values every host decision reads."""
        v = torch.stack(_i32(xs, self.device))
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=self._group)
        return v.cpu().numpy()

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The [q, ...] stack of every rank's [k, ...] block, in shard
        order (the reference's tiled all_gather)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.d)]
        dist.all_gather(parts, x, group=self._group)
        return torch.cat(parts)

    def _crossbar(self, cand_w: torch.Tensor) -> torch.Tensor:
        if self.cfg.crossbar == "staged":
            return or_reduce_scatter_staged(cand_w, self._axis_groups,
                                            self.axis_sizes)
        return or_reduce_scatter_flat(cand_w, self._group, self.d)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """[k, vl, ...] -> [k * vl, ...]."""
        return x.reshape(self.k * self.vl, *x.shape[2:])

    def _row_offsets(self) -> torch.Tensor:
        return (torch.arange(self.k, dtype=torch.int32, device=self.device)
                * self.vl)[:, None]

    def _readback(self, level: torch.Tensor) -> np.ndarray:
        """Every shard's levels gathered, put into the original vertex
        order on the device, read back once: [n] or [B, n] int64."""
        lev = self._all_gather(level).reshape(self.n_pad, -1)
        rows = lev[self._orig_pos].T.contiguous()          # [B, n]
        out = rows.cpu().numpy().astype(np.int64)
        return out[0] if level.dim() == 2 else out

    # -- single-source steps ------------------------------------------------
    def init_state(self, root_reindexed: int):
        k, vl = self.k, self.vl
        frontier = torch.zeros((k, self.wl), dtype=torch.int32,
                               device=self.device)
        level = torch.full((k, vl), INF, dtype=torch.int32,
                           device=self.device)
        shard, local = divmod(int(root_reindexed), vl)
        if shard // k == self.sidx:
            word = np.array([1 << (local % 32)], np.uint32).view(np.int32)
            frontier[shard % k, local // 32] = int(word[0])
            level[shard % k, local] = 0
        return frontier, frontier.clone(), level

    def _unpack(self, words: torch.Tensor) -> torch.Tensor:
        return bitmap.unpack_rows(words, self.vl)           # [k, vl]

    def _stats(self, frontier, visited) -> np.ndarray:
        fmask = self._unpack(frontier)
        umask = ~self._unpack(visited)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return self._psum(
            fmask.sum(dtype=torch.int32),
            torch.where(fmask, self._out_deg_dev, zero).sum(dtype=torch.int32),
            torch.where(umask, self._in_deg_dev, zero).sum(dtype=torch.int32),
            umask.sum(dtype=torch.int32))

    def _commit_single(self, cand_local, visited, level, lvl: int):
        new = cand_local & ~visited
        v2 = visited | new
        lev2 = torch.where(self._unpack(new), lvl + 1, level)
        return new, v2, lev2

    def _push(self, frontier, visited, level, lvl: int, budget: int):
        """Returns (new, visited, level, leftover, [overflow, total,
        pending] all-reduced)."""
        cfg, k, vl = self.cfg, self.k, self.vl
        active = _compact_rows(self._unpack(frontier))
        _, nbr, _, total = _expand_rows(active, self.out_indptr,
                                        self.out_indices, budget)
        nbr_flat = nbr.reshape(-1)
        if cfg.dispatch == "bitmap":
            cand_global = bitmap.from_indices_dense(nbr_flat, self.n_pad)
            cand_local = self._crossbar(cand_global).reshape(k, self.wl)
            leftover = torch.full((k, budget), -1, dtype=torch.int32,
                                  device=self.device)
        else:
            recv, leftover_f = queue_dispatch(nbr_flat, self._group, self.d,
                                              k * vl, cfg.queue_capacity)
            cand_local = received_to_local_bits(
                recv, self.sidx, k * vl).reshape(k, self.wl)
            leftover = leftover_f.reshape(k, budget)
        new, v2, lev2 = self._commit_single(cand_local, visited, level, lvl)
        sums = self._psum((total > budget).any(), total.sum(dtype=torch.int32),
                          (leftover >= 0).sum(dtype=torch.int32))
        return new, v2, lev2, leftover, sums

    def _queue_drain(self, frontier, visited, level, lvl: int, leftover):
        """Retry round for queue-mode overflow: dispatch leftover IDs."""
        k, vl = self.k, self.vl
        recv, left2 = queue_dispatch(leftover.reshape(-1), self._group,
                                     self.d, k * vl, self.cfg.queue_capacity)
        cand_local = received_to_local_bits(
            recv, self.sidx, k * vl).reshape(k, self.wl)
        new, v2, lev2 = self._commit_single(cand_local, visited, level, lvl)
        pending = self._psum((left2 >= 0).sum(dtype=torch.int32))[0]
        return frontier | new, v2, lev2, pending, left2.reshape(
            leftover.shape)

    def _pull(self, frontier, visited, level, lvl: int, budget: int):
        """Returns (new, visited, level, [overflow, total] all-reduced)."""
        # all-gather the packed frontier (W bits total = |V|): the pull
        # mode's "read current_frontier of remote parents"
        f_global = self._all_gather(frontier).reshape(-1)
        unvisited = _compact_rows(~self._unpack(visited))
        child, parent, valid, total = _expand_rows(
            unvisited, self.in_indptr, self.in_indices, budget)
        hit = bitmap.test_bits(f_global, parent.clamp(min=0)) & valid
        tgt = torch.where(hit, child + self._row_offsets(), -1)
        cand = bitmap.from_indices_dense(tgt.reshape(-1), self.k * self.vl)
        new, v2, lev2 = self._commit_single(cand.reshape(self.k, self.wl),
                                            visited, level, lvl)
        sums = self._psum((total > budget).any(),
                          total.sum(dtype=torch.int32))
        return new, v2, lev2, sums

    # -- batched multi-source steps (one bit-plane per source) ------------
    # State: frontier/seen int32[k, vl, nwb] (source-mask words per local
    # vertex), level int32[k, vl, B].  Dispatch is always bitmap-mode: the
    # crossbar payload is the packed source-mask plane set and combining
    # stays a bitwise OR, so the same OR-reduce-scatter delivers a whole
    # batch per exchange.  Each step returns the NEXT level's scheduler
    # stats in one all-reduced int32[7], so run_batch makes a single
    # blocking device->host transfer per level.

    def _ms_statvec_b(self, new, s2, total, overflow, nb: int) -> np.ndarray:
        pmask = bitmap.plane_mask(nb, self.device)
        any_f = bitmap.any_rows(new)                   # [k, vl]
        un_any = bitmap.any_rows(~s2 & pmask)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return self._psum(
            any_f.sum(dtype=torch.int32),
            torch.where(any_f, self._out_deg_dev, zero).sum(dtype=torch.int32),
            torch.where(un_any, self._in_deg_dev, zero).sum(dtype=torch.int32),
            un_any.sum(dtype=torch.int32), total, overflow,
            bitmap.popcount(new))

    def init_state_batch(self, roots_reindexed: np.ndarray):
        k, vl = self.k, self.vl
        b = int(roots_reindexed.size)
        nwb = bitmap.num_words(b)
        frontier = np.zeros((k, vl, nwb), np.uint32)
        level = torch.full((k, vl, b), INF, dtype=torch.int32,
                           device=self.device)
        for i, r in enumerate(np.asarray(roots_reindexed)):
            shard, local = divmod(int(r), vl)
            if shard // k == self.sidx:
                frontier[shard % k, local, i // 32] |= np.uint32(1) << (i % 32)
                level[shard % k, local, i] = 0
        f = torch.from_numpy(frontier.view(np.int32)).to(self.device)
        return f, f.clone(), level

    def _push_b(self, frontier, seen, level, lvl: int, budget: int, nb: int,
                program: VertexProgram, need: int):
        k, nwb = self.k, frontier.shape[2]
        active = _compact_rows(bitmap.any_rows(frontier))
        src, nbr, valid, total = _expand_rows(active, self.out_indptr,
                                              self.out_indices, budget)
        # P2->P3 on packed words: gather each edge's source-mask word,
        # scatter-OR into the GLOBAL candidate planes (the crossbar
        # payload), no bool intermediates.  The byte-plane scatter costs
        # 32 * nwb bytes a message, so only the valid slots go in: at most
        # ``need``, the level's edge count every rank read from the
        # statvec (the budget only grows, so a tail push level would
        # otherwise scatter millions of empty slots)
        cap = max(min(need, k * budget), 1)
        slot, _ = compact_indices(valid.reshape(-1), cap)
        ok = slot >= 0
        slot = slot.clamp(min=0).to(torch.int64)
        src_row = (src.clamp(min=0) + self._row_offsets()).reshape(-1)[slot]
        msg = self._rows(frontier)[src_row.to(torch.int64)]
        tgt = torch.where(ok, nbr.reshape(-1)[slot], self.n_pad)
        cand_w = bitmap._scatter_or_rows(
            torch.zeros((self.n_pad, nwb), dtype=torch.int32,
                        device=self.device), tgt, msg).reshape(-1)
        cand_local = self._crossbar(cand_w).reshape(k, self.vl, nwb)
        new = cand_local & ~seen
        s2 = seen | new
        lev2 = program.commit(level, bitmap.unpack_rows(new, nb), lvl)
        sv = self._ms_statvec_b(new, s2, total.sum(dtype=torch.int32),
                                (total > budget).any(), nb)
        return new, s2, lev2, sv

    def _pull_b(self, frontier, seen, level, lvl: int, budget: int, nb: int,
                program: VertexProgram):
        k, vl, nwb = self.k, self.vl, frontier.shape[2]
        # all-gather the packed source planes of every vertex: the pull
        # mode's "read current_frontier of remote parents", batched
        f_global = self._all_gather(frontier).reshape(-1, nwb)
        pmask = bitmap.plane_mask(nb, self.device)
        unvisited = _compact_rows(bitmap.any_rows(~seen & pmask))
        child, parent, valid, total = _expand_rows(
            unvisited, self.in_indptr, self.in_indices, budget)
        # packed P2->P3: parents' plane words combine into each PE's local
        # candidate words — the gather reads the all-gathered GLOBAL
        # frontier while the scatter stays shard-local, the msgs form's
        # contract
        msg = f_global[parent.clamp(min=0).reshape(-1).to(torch.int64)]
        tgt = torch.where(valid, child + self._row_offsets(), -1).reshape(-1)
        if self.use_kernels:
            # K2 over the k PE rows stacked flat: each tile lies inside one
            # PE's vertex interval (the paper's PC-feeds-its-own-partition
            # rule), and P3 fuses in-kernel
            from repro_torch.kernels import ops as kops
            new_f, s2_f, _ = kops.msbfs_propagate_msgs(
                self._rows(seen), msg, tgt, valid.reshape(-1),
                tile_rows=pull_tile_rows(vl, nwb, self.cfg.tile_rows),
                op=program.combine)
            new = new_f.reshape(k, vl, nwb)
            s2 = s2_f.reshape(k, vl, nwb)
        else:
            cand_w = bitmap._scatter_or_rows(
                torch.zeros((k * vl, nwb), dtype=torch.int32,
                            device=self.device), tgt, msg)
            new = cand_w.reshape(k, vl, nwb) & ~seen
            s2 = seen | new
        lev2 = program.commit(level, bitmap.unpack_rows(new, nb), lvl)
        sv = self._ms_statvec_b(new, s2, total.sum(dtype=torch.int32),
                                (total > budget).any(), nb)
        return new, s2, lev2, sv

    # -- driver -----------------------------------------------------------
    def _root_reindexed(self, roots: np.ndarray) -> np.ndarray:
        pg = self.pg
        if pg.scheme == "hash":
            return reindex(roots, pg.num_shards, pg.verts_per_shard)
        return roots

    def run(self, root: int, max_iters: int | None = None) -> np.ndarray:
        """BFS from original-ID ``root``; returns level int64[num_vertices]."""
        pg, cfg = self.pg, self.cfg
        root_r = int(self._root_reindexed(np.asarray(root)))
        frontier, visited, level = self.init_state(root_r)
        budget = cfg.edge_budget
        mode = PUSH
        iters = 0
        inspected = 0
        push_iters = pull_iters = 0
        max_iters = max_iters or self.n_pad
        while iters < max_iters:
            n_f, m_f, m_u, n_u = self._stats(frontier, visited)
            if int(n_f) == 0:
                break
            mode = choose_mode_host(cfg.scheduler, mode, int(n_f), int(m_f),
                                    int(m_u), pg.num_vertices, int(n_u))
            is_push = mode == PUSH
            need = int(m_f) if is_push else int(m_u)
            while budget * self.k < need:
                budget *= 2
            while True:
                if is_push:
                    (frontier2, visited2, level2, leftover,
                     (overflow, total, pending)) = self._push(
                        frontier, visited, level, iters, budget)
                else:
                    (frontier2, visited2, level2,
                     (overflow, total)) = self._pull(
                        frontier, visited, level, iters, budget)
                    pending = 0
                if int(overflow) == 0:
                    break
                budget *= 2            # HBM-reader queue deepening, retry
            # queue-mode FIFO overflow: extra dispatch rounds (same level)
            while int(pending) > 0:
                frontier2, visited2, level2, pending, leftover = \
                    self._queue_drain(frontier2, visited2, level2, iters,
                                      leftover)
            frontier, visited, level = frontier2, visited2, level2
            inspected += int(total)
            if is_push:
                push_iters += 1
            else:
                pull_iters += 1
            iters += 1
        out = self._readback(level)
        self.last_stats = dict(iterations=iters, edges_inspected=inspected,
                               push_iters=push_iters, pull_iters=pull_iters)
        return out

    def run_batch(self, roots, max_iters: int | None = None) -> np.ndarray:
        """Batched vertex program from original-ID ``roots`` (the engine's
        construction-time ``program``; BFS by default).

        Returns value rows int64[B, num_vertices].  All B planes run
        level-synchronously over the same sharded graph; every CSR/CSC
        edge read and every crossbar exchange carries the whole batch's
        plane masks (bitmap dispatch only — FIFO queues carry scalar
        vertex IDs and would lose the sharing).
        """
        return self.run_program_batch(self.program, roots, max_iters)

    def run_program_batch(self, program: VertexProgram, roots,
                          max_iters: int | None = None) -> np.ndarray:
        """One-sync-per-level batched driver, parameterized by program.

        The SHARED distributed entry: root validation happens here, once,
        for every algorithm.  ``last_level_seconds`` holds each level's
        host time (steps + statvec fetch, the readback excluded).
        """
        pg, cfg = self.pg, self.cfg
        if cfg.dispatch != "bitmap":
            raise NotImplementedError(
                "run_batch supports bitmap dispatch only: FIFO queues carry "
                "scalar vertex IDs, not per-source masks")
        if program.combine != "or":
            raise NotImplementedError(
                "the distributed crossbar is an OR-reduce-scatter; "
                f"program {program.name!r} wants combine={program.combine!r}")
        # validate BEFORE the int64 cast (a float root must error, not
        # truncate); duplicates are allowed — one plane slot each
        roots = validate_roots(np.asarray(roots),
                               pg.num_vertices).astype(np.int64)
        b = int(roots.size)
        frontier, seen, level = self.init_state_batch(
            self._root_reindexed(roots))
        # one-sync-per-level driver: every step returns the next level's
        # scheduler stats as ONE replicated int32[7]
        sv = self._ms_statvec_b(frontier, seen, 0, 0, b)
        budget = cfg.edge_budget
        mode = PUSH
        iters = 0
        inspected = 0
        push_iters = pull_iters = 0
        level_s: list[float] = []
        max_iters = max_iters or self.n_pad
        while iters < max_iters and not program.done(sv):
            t_lvl = time.perf_counter()
            mode = choose_mode_host(cfg.scheduler, mode, int(sv[SV_NF]),
                                    int(sv[SV_MF]), int(sv[SV_MU]),
                                    pg.num_vertices, int(sv[SV_NU]))
            is_push = mode == PUSH
            need = int(sv[SV_MF]) if is_push else int(sv[SV_MU])
            while budget * self.k < need:
                budget *= 2
            step = self._push_b if is_push else self._pull_b
            kw = dict(need=need) if is_push else {}
            while True:
                frontier2, seen2, level2, sv = step(
                    frontier, seen, level, iters, budget, b, program, **kw)
                if int(sv[SV_OVERFLOW]) == 0:
                    break
                budget *= 2            # HBM-reader queue deepening, retry
            frontier, seen, level = frontier2, seen2, level2
            inspected += int(sv[SV_TOTAL])
            if is_push:
                push_iters += 1
            else:
                pull_iters += 1
            iters += 1
            level_s.append(time.perf_counter() - t_lvl)
        out = self._readback(level)
        self.last_stats = dict(iterations=iters, edges_inspected=inspected,
                               push_iters=push_iters, pull_iters=pull_iters,
                               batch=b, algo=program.name)
        self.last_level_seconds = level_s
        return out
