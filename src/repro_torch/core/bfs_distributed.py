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
reference's is jnp.  ``abstract()`` / ``abstract_inputs()`` build the
graph-less engine of the dry-run (``launch.dryrun``), one rank of the
production mesh.

Leader and followers.  The group's first rank (``leader``) serves: its
``run_batch(roots)`` / ``run(root)`` first hands the call to the other
ranks in one small broadcast (op, batch, ``max_iters``, program and up to
``HEADER_ROOTS`` roots; a longer batch sends the rest in a second one),
then every rank runs the same level loop.  The other ranks either make the
same calls (SPMD; their arguments are checked, then the leader's are
used) or sit in :meth:`follow`, which serves the leader's calls until its
:meth:`close`.  ``launch.leader.start_group`` starts the followers from
the leader's process.

One readback path: the level blocks are gathered to the leader only,
put into original vertex order on its device and read back once into
page-locked host blocks reused across calls (``core.readback``), int32
``[B, n]`` as ``MultiSourceBFSRunner`` returns them; a follower returns
None.  ``last_stats`` holds the reference's counts and ``seconds`` (to
the last level's sync, the readback excluded), ``readback`` (the pool's
counts, leader) and ``exchange_bytes`` (by kind: what this rank sent in
the call's collectives; :data:`EXCHANGE_KINDS`).

Spans (``repro_torch.trace``, the local engines' names): ``init``; per
level ``level`` (args: its index) holding ``step`` (``expand``,
``exchange``, ``commit``, ``statvec`` inside it), ``statvec_fetch`` and
``retry``; ``readback`` (args: the rows' bytes) holding ``gather``; on a
follower ``follow`` (args: the call's sequence number) around each call.
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
from repro_torch.core.partition import PartitionedGraph, RankShards, reindex
from repro_torch.core.readback import PinnedPool
from repro_torch.core.scheduler import PUSH, SchedulerConfig, choose_mode_host
from repro_torch.core.vertex_program import BFS, PROGRAMS, VertexProgram
from repro_torch.launch.mesh import (axes_group, axis_size, flat_axis_index,
                                     mesh_device)
from repro_torch.trace import span

# What each kind of collective counts in ``last_stats["exchange_bytes"]``:
# the bytes this rank puts on the links for it.  crossbar: the all-to-all
# rows addressed to other ranks; all_gather: its block once to each peer;
# all_reduce: a ring's 2 (d - 1) / d of the vector; gather: its block to
# the leader (the leader sends none); roots: the leader's call header once
# to each peer.
EXCHANGE_KINDS = ("crossbar", "all_gather", "all_reduce", "gather", "roots")

# The leader's call header: op, batch, max_iters (0: none), program code,
# then up to HEADER_ROOTS roots.
_OP_CLOSE, _OP_BATCH, _OP_RUN = 0, 1, 2
HEADER_ROOTS = 256
_HEAD = 4
# A follower runs a program it is told by name; -1: not a registered one
# (only an SPMD call, which brings its own, can run it).
_PROGRAM_CODES = tuple(PROGRAMS)


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


class DistributedBFS:
    """Vertex-program engine over ``mesh``: Q = d*k shards, k PEs per rank.

    Every rank of the mesh constructs it, from the whole partition
    (``PartitionedGraph``, each rank keeping its own k shards) or from its
    own shards alone (``RankShards``); each holds only its own k shards on
    its device.  The leader's calls drive the group (see the module
    docstring).  The batched path is program-parameterized
    (``run_program_batch``): the default ``program`` (BFS unless
    overridden at construction) keeps ``run_batch`` protocol-uniform, so
    one ``DistributedBFS(pg, mesh, program=CC)`` serves CC through the
    same ``BFSEngine`` surface.
    """

    def __init__(self, pg: PartitionedGraph | RankShards, mesh,
                 axis_names: tuple[str, ...] | None = None,
                 cfg: DistConfig | None = None,
                 program: VertexProgram = BFS):
        self.pg = pg
        self.program = program
        self._bind_mesh(mesh, axis_names, cfg)
        q = pg.num_shards
        if q % self.d:
            raise ValueError(f"shards {q} not a multiple of mesh size "
                             f"{self.d}")
        self.k = q // self.d     # shards (PEs) per rank (PC)
        self.q = q
        self.vl = pg.verts_per_shard          # local vertices per shard
        self.wl = self.vl // bitmap.WORD_BITS  # local bitmap words
        self.n_pad = pg.num_vertices_padded
        if isinstance(pg, RankShards):
            if (pg.rank, pg.k) != (self.sidx, self.k):
                raise ValueError(f"shards of rank {pg.rank} ({pg.k} a rank) "
                                 f"given to rank {self.sidx} ({self.k})")
            mine = pg.to(self.device)
            out_deg = pg.out_deg
        else:
            mine = pg.rank_shards(self.sidx, self.k).to(self.device)
            out_deg = None
        # this rank's k shards of the shard-stacked graph arrays
        (self.out_indptr, self.out_indices, self.in_indptr,
         self.in_indices) = mine.tensors()
        # stored per-shard degrees: the per-level scheduler stats would
        # otherwise re-derive them every single iteration
        self._out_deg_dev = (self.out_indptr[:, 1:]
                             - self.out_indptr[:, :-1]).contiguous()
        self._in_deg_dev = (self.in_indptr[:, 1:]
                            - self.in_indptr[:, :-1]).contiguous()
        # original-order degrees for the engine protocol (per-wave TEPS)
        if out_deg is None and isinstance(pg, PartitionedGraph):
            pos = self._positions()
            out_deg = np.diff(pg.out_indptr, axis=1).reshape(-1)[pos]
        self._out_deg_np = (None if out_deg is None
                            else np.asarray(out_deg, dtype=np.int64))
        # reindexed position of every original vertex: the leader's
        # readback gathers rows into the original order on its device
        self._orig_pos = (torch.from_numpy(self._positions()).to(self.device)
                          if self.leader else None)

    def _positions(self) -> np.ndarray:
        pg = self.pg
        orig = np.arange(pg.num_vertices)
        return reindex(orig, self.q, self.vl) if pg.scheme == "hash" else orig

    def _bind_mesh(self, mesh, axis_names, cfg) -> None:
        """What construction and :meth:`abstract` share: the mesh's axes
        and its ``d`` ranks, the device, the kernel choice and the
        collectives' groups."""
        self.mesh = mesh
        self.axes = tuple(axis_names or mesh.mesh_dim_names)
        self.axis_sizes = tuple(axis_size(mesh, a) for a in self.axes)
        self.cfg = cfg or DistConfig()
        self.d = int(np.prod(self.axis_sizes))
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
        self.leader = self.sidx == 0
        self._pool = PinnedPool()
        self._sent = dict.fromkeys(EXCHANGE_KINDS, 0)
        self._closed = False
        self.last_stats: dict = {}
        self.last_level_seconds: list[float] = []

    @classmethod
    def abstract(cls, mesh, num_vertices: int,
                 axis_names: tuple[str, ...] | None = None,
                 cfg: DistConfig | None = None, align: int = 32,
                 pes_per_device: int = 1):
        """Graph-less engine for the dry-run (``launch.dryrun``): the
        reference's shard arithmetic (q = mesh size x ``pes_per_device``,
        ``vl`` = ceil(num_vertices / q) rounded up to ``align``) and no
        graph until :meth:`abstract_inputs` gives it stand-ins.  Its
        ``_push`` / ``_pull`` steps then run on this rank of ``mesh``."""
        self = cls.__new__(cls)
        self.pg = None
        self.program = BFS
        self._out_deg_np = None
        self._orig_pos = None
        self._bind_mesh(mesh, axis_names, cfg)
        self.k = pes_per_device
        self.q = self.d * pes_per_device
        vl = -(-num_vertices // self.q)
        self.vl = -(-vl // align) * align
        self.wl = self.vl // bitmap.WORD_BITS
        self.n_pad = self.q * self.vl
        return self

    def abstract_inputs(self, avg_degree: float = 16.0,
                        pad_multiple: int = 128) -> dict:
        """Zero-filled stand-ins for one BFS step's inputs on this rank's
        ``k`` shards, on the engine's device, in the reference's shapes:
        frontier / visited int32[k, wl], level int32[k, vl], lvl 0,
        indptr int32[k, vl + 1], indices int32[k, e] with e = vl x
        ``avg_degree`` rounded up to ``pad_multiple``.  The stand-ins also
        become the engine's graph (out- and in-lists alike), which its
        steps read.  Real tensors, not ``meta`` ones: a step reads its
        all-reduced sums back to the host."""
        e = int(self.vl * avg_degree)
        e = max(-(-e // pad_multiple) * pad_multiple, pad_multiple)
        k = self.k

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        sds = dict(frontier=zeros(k, self.wl), visited=zeros(k, self.wl),
                   level=zeros(k, self.vl), lvl=0,
                   indptr=zeros(k, self.vl + 1), indices=zeros(k, e))
        self.out_indptr = self.in_indptr = sds["indptr"]
        self.out_indices = self.in_indices = sds["indices"]
        self._out_deg_dev = self._in_deg_dev = zeros(k, self.vl)
        return sds

    @property
    def num_vertices(self) -> int:
        """|V| served (the :class:`repro_torch.core.BFSEngine` protocol)."""
        return int(self.pg.num_vertices)

    @property
    def out_deg(self) -> np.ndarray | None:
        """Original-order out-degrees [n] (engine protocol); None on a
        rank built from shards that did not bring them."""
        return self._out_deg_np

    @property
    def readback_stats(self) -> dict:
        """The leader's page-locked readback pool: ``PinnedPool.stats()``."""
        return self._pool.stats()

    # -- collectives --------------------------------------------------------
    def _count(self, kind: str, nbytes: int) -> None:
        self._sent[kind] += int(nbytes)

    def _psum_dev(self, *xs) -> torch.Tensor:
        """One all-reduce(SUM) of the int32 scalars and vectors ``xs``,
        left on the device."""
        v = torch.cat([torch.as_tensor(x, device=self.device).to(
            torch.int32).reshape(-1) for x in xs])
        self._count("all_reduce",
                    2 * (self.d - 1) * v.numel() * 4 // self.d)
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=self._group)
        return v

    def _psum(self, *xs) -> np.ndarray:
        """:meth:`_psum_dev`, fetched: the replicated values every host
        decision reads."""
        return self._psum_dev(*xs).cpu().numpy()

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The [q, ...] stack of every rank's [k, ...] block, in shard
        order (the reference's tiled all_gather)."""
        x = x.contiguous()
        self._count("all_gather", (self.d - 1) * x.numel() * x.element_size())
        out = torch.empty((self.d,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=self._group)
        return out.reshape((self.d * x.shape[0],) + tuple(x.shape[1:]))

    def _crossbar(self, cand_w: torch.Tensor) -> torch.Tensor:
        nbytes = cand_w.numel() * cand_w.element_size()
        if self.cfg.crossbar == "staged":
            for size in self.axis_sizes:
                self._count("crossbar", nbytes * (size - 1) // size)
                nbytes //= size
            return or_reduce_scatter_staged(cand_w, self._axis_groups,
                                            self.axis_sizes)
        self._count("crossbar", nbytes * (self.d - 1) // self.d)
        return or_reduce_scatter_flat(cand_w, self._group, self.d)

    def _queue(self, ids: torch.Tensor):
        """Queue-mode delivery of ``ids`` (one all-to-all of the FIFOs)."""
        cap = self.cfg.queue_capacity
        self._count("crossbar", (self.d - 1) * cap * 4)
        recv, left = queue_dispatch(ids, self._group, self.d,
                                    self.k * self.vl, cap)
        cand = received_to_local_bits(recv, self.sidx, self.k * self.vl)
        return cand.reshape(self.k, self.wl), left

    def _gather(self, x: torch.Tensor) -> torch.Tensor | None:
        """Every rank's [k, ...] block stacked [q, ...] on the leader, in
        shard order; None on the other ranks."""
        x = x.contiguous()
        if self.d == 1:
            return x
        dst = dist.get_global_rank(self._group, 0)
        if not self.leader:
            self._count("gather", x.numel() * x.element_size())
            dist.gather(x, None, dst=dst, group=self._group)
            return None
        out = torch.empty((self.d,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.gather(x, list(out.unbind(0)), dst=dst, group=self._group)
        return out.reshape((self.d * x.shape[0],) + tuple(x.shape[1:]))

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """[k, vl, ...] -> [k * vl, ...]."""
        return x.reshape(self.k * self.vl, *x.shape[2:])

    def _row_offsets(self) -> torch.Tensor:
        return (torch.arange(self.k, dtype=torch.int32, device=self.device)
                * self.vl)[:, None]

    def _readback(self, level: torch.Tensor) -> np.ndarray | None:
        """Every shard's levels gathered to the leader, put into the
        original vertex order on its device and read back once into the
        page-locked pool: int32 [n] (``level`` [k, vl]) or [B, n]
        (``level`` [k, vl, B]).  None on the other ranks."""
        b = 1 if level.dim() == 2 else int(level.shape[2])
        with span("readback", 4 * b * self.num_vertices):
            with span("gather"):
                lev = self._gather(level)
            if lev is None:
                return None
            flat = lev.reshape(self.n_pad, b)
            rows = torch.index_select(flat.T, 1, self._orig_pos)   # [B, n]
            del lev, flat
            self._pool.admit(rows)
            out = self._pool.fetch(rows)
        return out[0] if level.dim() == 2 else out

    # -- the leader's calls ---------------------------------------------------
    def _announce(self, op: int, roots: np.ndarray | None = None,
                  program: VertexProgram | None = None,
                  max_iters: int | None = None):
        """Hand the call to the group: the leader broadcasts it, every
        other rank receives it.  Returns the leader's (op, roots, program,
        max_iters); a program the header cannot name stays the caller's."""
        if self.d == 1:
            return op, roots, program, max_iters
        src = dist.get_global_rank(self._group, 0)
        if self.leader:
            b = 0 if roots is None else int(roots.size)
            code = (_PROGRAM_CODES.index(program.name)
                    if program is not None and program.name in _PROGRAM_CODES
                    and PROGRAMS[program.name] is program else -1)
            head = np.zeros(_HEAD + HEADER_ROOTS, dtype=np.int64)
            head[:_HEAD] = (op, b, max_iters or 0, code)
            if b:
                head[_HEAD:_HEAD + min(b, HEADER_ROOTS)] = roots[:HEADER_ROOTS]
            self._broadcast(torch.from_numpy(head), src)
            if b > HEADER_ROOTS:
                self._broadcast(torch.from_numpy(roots[HEADER_ROOTS:]), src)
            return op, roots, program, max_iters
        head = torch.empty(_HEAD + HEADER_ROOTS, dtype=torch.int64,
                           device=self.device)
        dist.broadcast(head, src=src, group=self._group)
        h = head.cpu().numpy()
        op, b, iters, code = (int(x) for x in h[:_HEAD])
        got = h[_HEAD:_HEAD + min(b, HEADER_ROOTS)]
        if b > HEADER_ROOTS:
            rest = torch.empty(b - HEADER_ROOTS, dtype=torch.int64,
                               device=self.device)
            dist.broadcast(rest, src=src, group=self._group)
            got = np.concatenate([got, rest.cpu().numpy()])
        if code >= 0:
            program = PROGRAMS[_PROGRAM_CODES[code]]
        elif op == _OP_BATCH and program is None:
            raise RuntimeError("the leader runs a program a follower cannot "
                               "name: make the same call on every rank")
        return op, got.astype(np.int64), program, iters or None

    def _broadcast(self, x: torch.Tensor, src: int) -> None:
        """The leader's int64 ``x`` to every rank of the group."""
        self._count("roots", (self.d - 1) * x.numel() * x.element_size())
        dist.broadcast(x.to(self.device), src=src, group=self._group)

    def follow(self) -> int:
        """On a rank other than the leader: serve the leader's calls, each
        with the same level loop, until the leader's :meth:`close`.  Returns
        the number of calls served."""
        if self.leader:
            raise RuntimeError("the leader calls run_batch, not follow")
        calls = 0
        while True:
            self._reset_counts()
            op, roots, program, max_iters = self._announce(_OP_CLOSE)
            if op == _OP_CLOSE:
                self._closed = True
                return calls
            with span("follow", calls):
                if op == _OP_BATCH:
                    self._run_batch(program, roots, max_iters)
                else:
                    self._run_single(int(roots[0]), max_iters)
            calls += 1

    def close(self) -> None:
        """End the group's calls: the leader releases the followers from
        :meth:`follow`; a rank making the leader's calls itself (SPMD)
        takes the same message.  Once only; a one-rank group has nothing
        to end."""
        if self._closed or self.d == 1:
            return
        op = self._announce(_OP_CLOSE)[0]
        self._closed = True
        if op != _OP_CLOSE:
            raise RuntimeError(f"close() met the leader's call {op}")

    def _reset_counts(self) -> None:
        self._sent = dict.fromkeys(EXCHANGE_KINDS, 0)

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
        cfg, k = self.cfg, self.k
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
            cand_local, leftover_f = self._queue(nbr_flat)
            leftover = leftover_f.reshape(k, budget)
        new, v2, lev2 = self._commit_single(cand_local, visited, level, lvl)
        sums = self._psum((total > budget).any(), total.sum(dtype=torch.int32),
                          (leftover >= 0).sum(dtype=torch.int32))
        return new, v2, lev2, leftover, sums

    def _queue_drain(self, frontier, visited, level, lvl: int, leftover):
        """Retry round for queue-mode overflow: dispatch leftover IDs."""
        cand_local, left2 = self._queue(leftover.reshape(-1))
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
    # stats in one all-reduced int32[7 + 2d] left on the device, so
    # run_batch makes a single blocking device->host transfer per level:
    # the seven sums of ``bfs_local``'s statvec, then each rank's largest
    # shard's push need (out-degrees of its frontier) at [7 + rank] and
    # pull need (in-degrees of its unvisited) at [7 + d + rank].

    def _ms_statvec_b(self, new, s2, total, overflow, nb: int
                      ) -> torch.Tensor:
        with span("statvec"):
            pmask = bitmap.plane_mask(nb, self.device)
            any_f = bitmap.any_rows(new)                   # [k, vl]
            un_any = bitmap.any_rows(~s2 & pmask)
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            m_f = torch.where(any_f, self._out_deg_dev, zero).sum(
                1, dtype=torch.int32)                      # [k]
            m_u = torch.where(un_any, self._in_deg_dev, zero).sum(
                1, dtype=torch.int32)
            need = torch.zeros(2 * self.d, dtype=torch.int32,
                               device=self.device)
            need[self.sidx] = m_f.max()
            need[self.d + self.sidx] = m_u.max()
            return self._psum_dev(
                any_f.sum(dtype=torch.int32), m_f.sum(dtype=torch.int32),
                m_u.sum(dtype=torch.int32), un_any.sum(dtype=torch.int32),
                total, overflow, bitmap.popcount(new), need)

    def _shard_need(self, sv: np.ndarray, push: bool) -> int:
        """The largest shard's expansion need, from the statvec."""
        lo = len(sv) - 2 * self.d + (0 if push else self.d)
        return int(sv[lo:lo + self.d].max())

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
        with span("expand"):
            active = _compact_rows(bitmap.any_rows(frontier))
            src, nbr, valid, total = _expand_rows(active, self.out_indptr,
                                                  self.out_indices, budget)
            # P2->P3 on packed words: gather each edge's source-mask word,
            # scatter-OR into the GLOBAL candidate planes (the crossbar
            # payload), no bool intermediates.  The byte-plane scatter
            # costs 32 * nwb bytes a message, so only the valid slots go
            # in: at most ``need``, the level's edge count every rank read
            # from the statvec (the budget only grows, so a tail push
            # level would otherwise scatter millions of empty slots)
            cap = max(min(need, k * budget), 1)
            slot, _ = compact_indices(valid.reshape(-1), cap)
            ok = slot >= 0
            slot = slot.clamp(min=0).to(torch.int64)
            src_row = (src.clamp(min=0) + self._row_offsets()).reshape(
                -1)[slot]
            msg = self._rows(frontier)[src_row.to(torch.int64)]
            tgt = torch.where(ok, nbr.reshape(-1)[slot], self.n_pad)
            cand_w = bitmap._scatter_or_rows(
                torch.zeros((self.n_pad, nwb), dtype=torch.int32,
                            device=self.device), tgt, msg).reshape(-1)
            del src, nbr, valid, slot, ok, src_row, msg, tgt
        with span("exchange"):
            cand_local = self._crossbar(cand_w).reshape(k, self.vl, nwb)
        with span("commit"):
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
        with span("exchange"):
            f_global = self._all_gather(frontier).reshape(-1, nwb)
        with span("expand"):
            pmask = bitmap.plane_mask(nb, self.device)
            unvisited = _compact_rows(bitmap.any_rows(~seen & pmask))
            child, parent, valid, total = _expand_rows(
                unvisited, self.in_indptr, self.in_indices, budget)
            # packed P2->P3: parents' plane words combine into each PE's
            # local candidate words — the gather reads the all-gathered
            # GLOBAL frontier while the scatter stays shard-local, the
            # msgs form's contract
            msg = f_global[parent.clamp(min=0).reshape(-1).to(torch.int64)]
            tgt = torch.where(valid, child + self._row_offsets(),
                              -1).reshape(-1)
            del f_global, unvisited, child, parent
        with span("commit"):
            if self.use_kernels:
                # K2 over the k PE rows stacked flat: each tile lies inside
                # one PE's vertex interval (the paper's PC-feeds-its-own-
                # partition rule), and P3 fuses in-kernel
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
            del msg, tgt, valid
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

    def run(self, root: int, max_iters: int | None = None
            ) -> np.ndarray | None:
        """BFS from original-ID ``root``; returns level int32[num_vertices]
        on the leader, None on the other ranks."""
        root = int(validate_roots(np.asarray([root]), self.num_vertices)[0])
        self._reset_counts()
        _, roots, _, max_iters = self._announce(
            _OP_RUN, np.asarray([root], dtype=np.int64), None, max_iters)
        return self._run_single(int(roots[0]), max_iters)

    def _run_single(self, root: int, max_iters: int | None):
        pg, cfg = self.pg, self.cfg
        t0 = time.perf_counter()
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
            with span("level", iters):
                mode = choose_mode_host(cfg.scheduler, mode, int(n_f),
                                        int(m_f), int(m_u), pg.num_vertices,
                                        int(n_u))
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
                    budget *= 2            # HBM-reader queue deepening
                # queue-mode FIFO overflow: extra dispatch rounds (same
                # level)
                while int(pending) > 0:
                    frontier2, visited2, level2, pending, leftover = \
                        self._queue_drain(frontier2, visited2, level2,
                                          iters, leftover)
            frontier, visited, level = frontier2, visited2, level2
            inspected += int(total)
            if is_push:
                push_iters += 1
            else:
                pull_iters += 1
            iters += 1
        seconds = time.perf_counter() - t0
        out = self._readback(level)
        self.last_stats = dict(iterations=iters, edges_inspected=inspected,
                               push_iters=push_iters, pull_iters=pull_iters)
        self._finish_stats(seconds)
        return out

    def run_batch(self, roots, max_iters: int | None = None
                  ) -> np.ndarray | None:
        """Batched vertex program from original-ID ``roots`` (the engine's
        construction-time ``program``; BFS by default).

        Returns value rows int32[B, num_vertices] on the leader, None on
        the other ranks.  All B planes run level-synchronously over the
        same sharded graph; every CSR/CSC edge read and every crossbar
        exchange carries the whole batch's plane masks (bitmap dispatch
        only — FIFO queues carry scalar vertex IDs and would lose the
        sharing).
        """
        return self.run_program_batch(self.program, roots, max_iters)

    def run_program_batch(self, program: VertexProgram, roots,
                          max_iters: int | None = None
                          ) -> np.ndarray | None:
        """One-sync-per-level batched driver, parameterized by program.

        The SHARED distributed entry: root validation happens here, once,
        for every algorithm, before the call reaches the group.
        ``last_level_seconds`` holds each level's host time (steps +
        statvec fetch, the readback excluded).
        """
        if self.cfg.dispatch != "bitmap":
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
                               self.num_vertices).astype(np.int64)
        self._reset_counts()
        _, roots, program, max_iters = self._announce(
            _OP_BATCH, roots, program, max_iters)
        return self._run_batch(program, roots, max_iters)

    def _fetch_sv(self, sv: torch.Tensor) -> np.ndarray:
        with span("statvec_fetch"):
            return sv.cpu().numpy()

    def _run_batch(self, program: VertexProgram, roots: np.ndarray,
                   max_iters: int | None):
        pg, cfg = self.pg, self.cfg
        t0 = time.perf_counter()
        b = int(roots.size)
        with span("init"):
            frontier, seen, level = self.init_state_batch(
                self._root_reindexed(roots))
            # one-sync-per-level driver: every step returns the next
            # level's scheduler stats as ONE replicated int32 vector
            sv = self._fetch_sv(self._ms_statvec_b(frontier, seen, 0, 0, b))
        budget = cfg.edge_budget
        mode = PUSH
        iters = 0
        inspected = 0
        push_iters = pull_iters = 0
        level_s: list[float] = []
        max_iters = max_iters or self.n_pad
        while iters < max_iters and not program.done(sv):
            t_lvl = time.perf_counter()
            with span("level", iters):
                mode = choose_mode_host(cfg.scheduler, mode, int(sv[SV_NF]),
                                        int(sv[SV_MF]), int(sv[SV_MU]),
                                        pg.num_vertices, int(sv[SV_NU]))
                is_push = mode == PUSH
                need = int(sv[SV_MF]) if is_push else int(sv[SV_MU])
                # the budget is a shard's: sized from the largest shard's
                # need, so no shard overflows and none is over-provisioned
                shard_need = self._shard_need(sv, is_push)
                while budget < shard_need:
                    budget *= 2
                step = self._push_b if is_push else self._pull_b
                kw = dict(need=need) if is_push else {}
                with span("step"):
                    new = step(frontier, seen, level, iters, budget, b,
                               program, **kw)
                sv = self._fetch_sv(new[3])
                while int(sv[SV_OVERFLOW]):
                    budget *= 2        # HBM-reader queue deepening, retry
                    with span("retry"):
                        new = step(frontier, seen, level, iters, budget, b,
                                   program, **kw)
                        sv = new[3].cpu().numpy()
                frontier, seen, level = new[:3]
                del new
            inspected += int(sv[SV_TOTAL])
            if is_push:
                push_iters += 1
            else:
                pull_iters += 1
            iters += 1
            level_s.append(time.perf_counter() - t_lvl)
        seconds = time.perf_counter() - t0
        out = self._readback(level)
        self.last_stats = dict(iterations=iters, edges_inspected=inspected,
                               push_iters=push_iters, pull_iters=pull_iters,
                               batch=b, algo=program.name)
        self._finish_stats(seconds)
        self.last_level_seconds = level_s
        return out

    def _finish_stats(self, seconds: float) -> None:
        """The counts every call adds to the reference's ``last_stats``."""
        self.last_stats.update(seconds=seconds,
                               exchange_bytes=dict(self._sent))
        if self.leader:
            self.last_stats["readback"] = self._pool.stats()
