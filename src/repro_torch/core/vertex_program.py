"""Batched vertex-program engine: the packed MS-BFS pipeline and its
instantiations (PyTorch port of ``repro.core.vertex_program``).

Frontier/seen state is a per-vertex PLANE mask — bit b of row v says
"plane b has reached v" — packed into int32[n_pad, ceil(B/32)] words that
hold the reference's uint32 bits.  Every CSR/CSC edge read is shared by
the whole batch (MS-BFS sharing; Then et al., VLDB'14).  The driver is the
reference's one-sync-per-level loop: each step returns a stacked int32[7]
statvec, the host fetches it once per level, picks the next direction and
deepens the edge budget on overflow, so
``result.host_transfers == iterations + 2``.

``use_kernels`` routes the propagate through the hand-written CUDA kernels
(``kernels.ops``): None means kernels iff the graph lives on CUDA; True on
the CPU runs the kernel wrappers' plain bodies (how the CPU tests cover the
kernel path's wiring); False on a CUDA graph raises — the plain path (the
reference's jnp fallback) is a CPU path only.

Instantiations: :class:`MultiSourceBFSRunner` (BFS, plus the bool-plane
baseline ``packed=False``, whose P3 is kernel K3 under ``use_kernels``),
:class:`ConnectedComponentsRunner` (multi-seed CC over the symmetrized
graph) and :class:`SSSPRunner` (unit-weight hop distances).  The packed
runners can check their own state (``integrity``: a statvec residue slot,
host guards and a sampled parent-witness reduction, all inside the same
transfers) and bound their overflow retries (``max_overflow_retries``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bitmap
from repro_torch.core.bitmap import drop_index
from repro_torch.core.bfs_local import (INF, SV_COUNT, SV_MF, SV_MU, SV_NF,
                                        SV_NU, SV_OVERFLOW, SV_TOTAL,
                                        LocalGraph, compact_indices,
                                        count_traversed_edges,
                                        resolve_use_kernels, validate_roots)
from repro_torch.core.readback import PinnedPool
from repro_torch.core.scheduler import (PUSH, SchedulerConfig, choose_mode,
                                        choose_mode_host)
from repro_torch.kernels import expand_frontier as kef
from repro_torch.trace import span


# ---------------------------------------------------------------------------
# Algorithm bundle
# ---------------------------------------------------------------------------

def plane_seed_init(g: LocalGraph, roots: torch.Tensor):
    """One bit-plane per root, value INF except 0 at the root.

    ``value`` is int32[n_pad, B] (levels for BFS).  Frontier and seen
    start identical (the roots themselves)."""
    b = roots.shape[0]
    cols = torch.arange(b, device=roots.device)
    planes = torch.zeros((g.n_pad, b), dtype=torch.bool, device=roots.device)
    planes[roots, cols] = True
    frontier = bitmap.pack_rows(planes)
    value = torch.full((g.n_pad, b), INF, dtype=torch.int32,
                       device=roots.device)
    value[roots, cols] = 0
    return frontier, frontier, value


def level_commit(value, new_mask, lvl):
    """BFS apply: a vertex first reached at level ``lvl+1`` keeps it."""
    return torch.where(new_mask, lvl + 1, value)


def minplus_commit(value, new_mask, lvl):
    """SSSP (unit weights) apply: min-plus relaxation dist = min(dist,
    lvl+1) over newly-relaxed planes.  With unit weights first arrival IS
    the minimum, so this converges in the same level-synchronous sweeps."""
    return torch.minimum(value,
                         torch.full_like(value, INF).masked_fill_(new_mask,
                                                                  lvl + 1))


def frontier_drained(sv: np.ndarray) -> bool:
    """Convergence predicate: no plane produced a new discovery."""
    return int(sv[SV_NF]) == 0


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Per-algorithm bundle plugged into the shared engine.
    ``undirected=True`` means the algorithm needs the symmetrized graph
    (engine builders symmetrize first; the engine itself is
    orientation-agnostic)."""

    name: str
    init: Callable = plane_seed_init
    commit: Callable = level_commit
    done: Callable = frontier_drained
    combine: str = "or"          # plane merge op (see kernels.ops)
    undirected: bool = False


BFS = VertexProgram(name="bfs")
CC = VertexProgram(name="cc", undirected=True)
SSSP = VertexProgram(name="sssp", commit=minplus_commit)


class IntegrityError(RuntimeError):
    """A traversal integrity invariant was violated: the wave's answer
    cannot be trusted and must not be served (``integrity != "off"``)."""


class BudgetOverflowError(RuntimeError):
    """The edge budget still overflowed after ``max_overflow_retries``.

    By default the driver absorbs an overflowed (truncated) step by
    doubling the budget and re-running the level.  With
    ``max_overflow_retries`` set, persistent overflow surfaces as this
    error carrying the last budget tried, so a serving layer can retry the
    wave with a larger starting ``budget=``."""

    def __init__(self, budget: int, need: int, retries: int):
        super().__init__(
            f"push budget overflowed {retries}x (budget={budget}, "
            f"level needs ~{need} edges)")
        self.budget = int(budget)
        self.need = int(need)
        self.retries = int(retries)


PROGRAMS = {p.name: p for p in (BFS, CC, SSSP)}


def get_program(name: str) -> VertexProgram:
    try:
        return PROGRAMS[name]
    except KeyError:
        raise ValueError(f"unknown vertex program {name!r}; "
                         f"have {sorted(PROGRAMS)}") from None


# ---------------------------------------------------------------------------
# Shared packed-plane machinery
# ---------------------------------------------------------------------------

# index of the optional integrity slot appended to the statvec when a
# runner checks its state (int32[8] instead of int32[7])
SV_CHECK = 7

# runner integrity levels, strictly ordered by cost:
#   off        - no checks
#   invariants - device-side statvec residue + host popcount/row checks
#   witness    - invariants + a per-wave sampled parent-witness reduction
#   audit      - witness at engine level (the reference's supervisor adds
#                a sampled differential audit; the supervisor is not
#                ported yet)
INTEGRITY_MODES = ("off", "invariants", "witness", "audit")


def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _integrity_chk(frontier_w, seen_w, nb: int):
    """Device-side plane-word invariant residue (0 on an uncorrupted run):
    the popcount of ``frontier & ~seen`` (frontier is a subset of seen by
    construction) plus the frontier's and seen's pad bits beyond the true
    batch width (always zero)."""
    pmask = bitmap.plane_mask(nb, frontier_w.device)
    return (bitmap.popcount(frontier_w & ~seen_w)
            + bitmap.popcount(frontier_w & ~pmask)
            + bitmap.popcount(seen_w & ~pmask))


def _vp_statvec(g: LocalGraph, new_w, seen_w, total, overflow, nb: int,
                chk=None):
    """Fused per-level stats: scheduler inputs for the NEXT level, this
    step's edge total/overflow and the discovery popcount, stacked into
    one int32[7] so the driver fetches a single tensor per level (int32[8]
    with the integrity residue ``chk`` appended when checking is on).

    ``nb`` is the TRUE batch size: the pad planes of the last word are
    unseen by construction and must be masked out."""
    dev = new_w.device
    pmask = bitmap.plane_mask(nb, dev)
    any_f = bitmap.any_rows(new_w)
    un_any = bitmap.any_rows(~seen_w & pmask)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    slots = [
        any_f.sum(dtype=torch.int32),
        torch.where(any_f, g.out_deg, zero).sum(dtype=torch.int32),
        torch.where(un_any, g.in_deg, zero).sum(dtype=torch.int32),
        un_any.sum(dtype=torch.int32),
        _as_i32(total, dev),
        _as_i32(overflow, dev),
        bitmap.popcount(new_w),
    ]
    if chk is not None:
        slots.append(_as_i32(chk, dev))
    return torch.stack(slots)


def _vp_commit(g: LocalGraph, program: VertexProgram, new_w, seen_w, value,
               lvl, total, overflow, chk=None):
    """Per-level apply (the pipeline's single unpack point) + fused stats."""
    with span("commit"):
        new_mask = bitmap.unpack_rows(new_w, value.shape[1])
        value2 = program.commit(value, new_mask, lvl)
    with span("statvec"):
        return value2, _vp_statvec(g, new_w, seen_w, total, overflow,
                                   value.shape[1], chk)


def _propagate_edges(g: LocalGraph, frontier_w, seen_w, src, tgt, valid,
                     use_kernels: bool, combine: str = "or",
                     tile_rows: int | None = None, n_edges=None):
    """Fused P2->P3 on packed words: cand[tgt] (+)= frontier[src], then
    new = cand & ~seen, seen |= new.  Kernel path (``kernels.ops``) or the
    plain scatter-OR.  ``tile_rows`` selects the kernel (None = auto, see
    ``kernels.ops.propagate_plan``; 0 = whole-array, > 0 = row-tiled).
    ``n_edges``: the expansion's edge total (a device scalar), the prefix
    of slots ``valid`` may hold; the whole-array kernel reads no slot past
    it."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        new, seen2, _ = kops.msbfs_propagate(frontier_w, seen_w, src, tgt,
                                             valid, op=combine,
                                             tile_rows=tile_rows,
                                             n_edges=n_edges)
        return new, seen2
    if combine != "or":
        raise NotImplementedError(
            f"the plain path implements combine='or' only, got {combine!r}")
    msg = frontier_w[src.clamp(min=0).to(torch.int64)]
    cand = bitmap._scatter_or_rows(
        torch.zeros_like(frontier_w), torch.where(valid, tgt, g.n_pad), msg)
    new = cand & ~seen_w
    return new, seen_w | new


def _propagate_pull_scan(g: LocalGraph, frontier_w):
    """Candidate plane words for ALL vertices via the CSC edge stream:
    cand[v] = OR of frontier[parent] over v's in-list, by a segmented OR
    over the child-grouped stream read at each segment's end."""
    if g.in_indices.shape[0] == 0:
        return torch.zeros_like(frontier_w)
    msg = frontier_w[g.in_indices.to(torch.int64)]           # [E, nw]
    scan = bitmap.segment_or_rows(msg, g.in_seg_first)
    at_end = scan[g.in_seg_end.clamp(min=0).to(torch.int64)]
    return torch.where((g.in_seg_end >= 0)[:, None], at_end, 0)


def _unseen_any(seen_w, nb: int):
    return bitmap.any_rows(~seen_w & bitmap.plane_mask(nb, seen_w.device))


def _propagate_pull_sparse(g: LocalGraph, frontier_w, seen_w, nb: int,
                           budget: int):
    """Budgeted pull: expand ONLY some-plane-unseen vertices' in-lists and
    reduce each with the segmented OR, over ``budget`` edges instead of E.

    Returns (new, seen2, total); ``total > budget`` means the step was
    truncated and must be retried deeper (same contract as push)."""
    dev = frontier_w.device
    active, _ = compact_indices(_unseen_any(seen_w, nb), g.n_pad)
    a = active.clamp(min=0).to(torch.int64)
    deg = ((g.in_indptr[a + 1] - g.in_indptr[a]) * (active >= 0)
           ).to(torch.int64)
    cum = torch.cumsum(deg, 0)
    total = cum[-1].to(torch.int32)
    e = torch.arange(budget, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(cum, e, right=True)
    owner_c = owner.clamp(max=active.shape[0] - 1)
    start = cum[owner_c] - deg[owner_c]
    child = active[owner_c]
    eidx = g.in_indptr[child.clamp(min=0).to(torch.int64)].to(torch.int64) \
        + (e - start)
    valid = e < cum[-1]
    parent = g.in_indices[torch.where(valid, eidx, 0)].to(torch.int64)
    msg = torch.where(valid[:, None], frontier_w[parent], 0)
    scan = bitmap.segment_or_rows(msg, e == start)
    # one segment end per active vertex -> unique targets; the pad slots
    # land in trash row n_pad, sliced off
    endpos = (cum - 1).clamp(0, budget - 1)
    rows = torch.where((deg > 0) & (active >= 0), a, g.n_pad)
    cand = torch.zeros((g.n_pad + 1, frontier_w.shape[1]),
                       dtype=frontier_w.dtype, device=dev)
    cand.index_copy_(0, rows, scan[endpos])
    cand = cand[:-1]
    new = cand & ~seen_w
    return new, seen_w | new, total


def _plane_traversed(g: LocalGraph, value):
    """int32[B]: per-plane traversed edges = sum of out-degrees over the
    vertices each plane reached (the paper's TEPS numerator)."""
    reached = value[: g.n] < INF
    deg = g.out_deg[: g.n, None]
    return torch.where(reached, deg, 0).sum(0, dtype=torch.int32)


def _witness_check(g: LocalGraph, value, sample, budget: int):
    """Sampled parent-witness audit, one fused reduction.

    For every sampled vertex ``v`` and plane ``p`` with a finite non-root
    value, some in-neighbour ``u`` must hold ``value[u, p] == value[v, p]
    - 1`` (level-synchronous BFS/CC and unit-weight SSSP all satisfy this
    exactly).  The K sampled in-lists are expanded with the budgeted
    owner-slot pattern of the sparse pull and the predicate is OR-reduced
    per (vertex, plane) through a trash row.  Returns int32[2] =
    (violations, truncated); ``truncated != 0`` means the in-lists
    overflowed ``budget`` and the count is unusable."""
    dev = value.device
    k = sample.shape[0]
    s = sample.to(torch.int64)
    deg = (g.in_indptr[s + 1] - g.in_indptr[s]).to(torch.int64)
    cum = torch.cumsum(deg, 0)
    total = cum[-1]
    e = torch.arange(budget, dtype=torch.int64, device=dev)
    owner_c = torch.searchsorted(cum, e, right=True).clamp(max=k - 1)
    start = cum[owner_c] - deg[owner_c]
    child = s[owner_c]
    eidx = g.in_indptr[child].to(torch.int64) + (e - start)
    valid = e < total
    if g.in_indices.shape[0]:
        parent = g.in_indices[torch.where(valid, eidx, 0)].to(torch.int64)
    else:
        parent = torch.zeros_like(e)
    ok_e = valid[:, None] & (value[parent] == value[child] - 1)
    ok = torch.zeros((k + 1, value.shape[1]), dtype=torch.uint8, device=dev)
    rows = torch.where(valid, owner_c, k)
    ok.scatter_reduce_(0, rows[:, None].expand(-1, value.shape[1]),
                       ok_e.to(torch.uint8), "amax")
    vals = value[s]                                   # [K, B]
    need = (vals > 0) & (vals < INF)
    return torch.stack([(need & ~ok[:-1].to(torch.bool)).sum(
        dtype=torch.int32), (total > budget).to(torch.int32)])


def _xor_plane_bit(words, vertex: int, plane: int):
    """Flip one bit of one packed plane word (the chaos layer's HBM
    bit-flip analogue).  XOR, not OR: a flip of a set bit suppresses a
    discovery rather than conjuring one.  Returns a new tensor; bit 31 is
    the int32 with the same bits (``1 << 31`` overflows int32)."""
    word, bit = divmod(int(plane), bitmap.WORD_BITS)
    out = words.clone()
    out[int(vertex), word] ^= bitmap.INT32_MIN if bit == 31 else 1 << bit
    return out


def vp_init_state(g: LocalGraph, roots: torch.Tensor, program: VertexProgram,
                  check: bool = False):
    frontier, seen, value = program.init(g, roots)
    chk = _integrity_chk(frontier, seen, roots.shape[0]) if check else None
    return (frontier, seen, value,
            _vp_statvec(g, frontier, seen, 0, 0, roots.shape[0], chk))


def push_edges(g: LocalGraph, frontier_w, budget: int):
    """The push step's budgeted edge list: out-lists of any-plane frontier
    vertices.  Returns (src, tgt, valid, total)."""
    return kef.expand_frontier(bitmap.any_rows(frontier_w), g.out_indptr,
                         g.out_indices, budget)


def pull_edges(g: LocalGraph, seen_w, nb: int, budget: int):
    """The kernel pull's budgeted edge list: in-lists of some-plane-unseen
    vertices, as (src=parent, tgt=child, valid, total)."""
    child, parent, valid, total = kef.expand_frontier(
        _unseen_any(seen_w, nb), g.in_indptr, g.in_indices, budget)
    return parent, child, valid, total


def vp_push_step(g: LocalGraph, frontier_w, seen_w, value, lvl,
                 program: VertexProgram, budget: int,
                 use_kernels: bool = False, tile_rows: int | None = None,
                 check: bool = False):
    """Batched push on packed words: each budgeted out-edge carries its
    endpoint's packed plane word into the candidate planes (fused
    P2->P3).  Returns (new, seen2, value2, statvec); inputs are never
    written.  With ``check`` the statvec carries the integrity residue of
    the step's INPUT state (it indicts the words the step consumed)."""
    chk = _integrity_chk(frontier_w, seen_w, value.shape[1]) if check \
        else None
    with span("expand"):
        src, nbr, valid, total = push_edges(g, frontier_w, budget)
    with span("propagate"):
        new, seen2 = _propagate_edges(g, frontier_w, seen_w, src, nbr, valid,
                                      use_kernels, program.combine,
                                      tile_rows, total)
    value2, statvec = _vp_commit(g, program, new, seen2, value, lvl, total,
                                 total > budget, chk)
    return new, seen2, value2, statvec


def vp_pull_step(g: LocalGraph, frontier_w, seen_w, value, lvl,
                 program: VertexProgram, budget: int = 0,
                 use_kernels: bool = False, tile_rows: int | None = None,
                 check: bool = False):
    """Batched pull on packed words.

    Kernel path: budgeted expansion of the some-plane-unseen in-lists
    through the fused propagate.  Plain path: ``budget == 0`` is the dense
    segmented OR over the whole CSC stream (never overflows), ``budget >
    0`` the sparse budgeted pull of tail levels."""
    nb = value.shape[1]
    chk = _integrity_chk(frontier_w, seen_w, nb) if check else None
    if use_kernels:
        with span("expand"):
            parent, child, valid, total = pull_edges(g, seen_w, nb, budget)
        with span("propagate"):
            new, seen2 = _propagate_edges(g, frontier_w, seen_w, parent,
                                          child, valid, True,
                                          program.combine, tile_rows, total)
        overflow = total > budget
    elif budget:
        with span("propagate"):     # the expansion is fused into it
            new, seen2, total = _propagate_pull_sparse(g, frontier_w, seen_w,
                                                       nb, budget)
        overflow = total > budget
    else:
        with span("propagate"):
            cand = _propagate_pull_scan(g, frontier_w)
            new = cand & ~seen_w
            seen2 = seen_w | new
        total = int(g.in_indices.shape[0])
        overflow = 0
    value2, statvec = _vp_commit(g, program, new, seen2, value, lvl, total,
                                 overflow, chk)
    return new, seen2, value2, statvec


def vp_reference(g: LocalGraph, roots, program: VertexProgram = BFS,
                 max_iters: int | None = None):
    """Dense vertex-program loop (packed words, pull-form edge-parallel
    steps over the whole CSC stream).  Returns value rows [B, n] as a
    tensor on the graph's device."""
    roots = torch.as_tensor(np.asarray(roots), device=g.device).to(
        torch.int64)
    max_iters = max_iters or g.n_pad
    frontier, seen, value = program.init(g, roots)
    lvl = 0
    while lvl < max_iters and bool(bitmap.any_rows(frontier).any()):
        cand = _propagate_pull_scan(g, frontier)
        new = cand & ~seen
        seen = seen | new
        value = program.commit(value, bitmap.unpack_rows(new, roots.shape[0]),
                               lvl)
        frontier = new
        lvl += 1
    return value[: g.n].T


def msbfs_reference(g: LocalGraph, roots, max_iters: int | None = None):
    """Dense MS-BFS loop (packed words).  Returns level [B, n]."""
    return vp_reference(g, roots, BFS, max_iters)


# ---------------------------------------------------------------------------
# Results + the one-sync-per-level driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VertexProgramResult:
    levels: np.ndarray          # int32[B, n] — one value row per plane
    batch: int
    iterations: int
    edges_inspected: int        # edges streamed per level, summed
    push_iters: int
    pull_iters: int
    traversed_edges: int        # summed over all planes (paper §VI-A metric)
    seconds: float
    host_transfers: int = 0     # blocking device->host fetches during run
    algo: str = "bfs"
    labels: np.ndarray | None = None   # CC: int64[n] min-seed labels
    overflow_retries: int = 0   # levels re-run after a truncated push/pull
    budget: int = 0             # final edge budget the run settled on

    @property
    def distances(self) -> np.ndarray:
        """SSSP alias: the value rows are hop distances."""
        return self.levels

    @property
    def aggregate_teps(self) -> float:
        return self.traversed_edges / max(self.seconds, 1e-12)

    @property
    def gteps(self) -> float:
        return self.aggregate_teps / 1e9


# The reference's older name: BFS results are the same record.
MSBFSResult = VertexProgramResult


class VertexProgramRunner:
    """Python-driven hybrid vertex-program engine over a batch of roots.

    Per level: stats -> mode -> gather/scan step -> commit, one bit-plane
    per root, with exactly one blocking device->host transfer (the fused
    statvec): ``result.host_transfers == iterations + 2``.  ``run`` is the
    shared entry and validates the roots once.

    After a run, ``last_stats`` holds the reference's counters, the port's
    ``budget_slots`` (the slots the steps' expansions wrote: their budgets
    summed, overflowed tries included; ``edges_inspected`` over it is the
    share that held an edge) and ``last_level_seconds`` the host time of
    each level (step + statvec fetch; the fetch synchronises, so it
    covers the device work).  Each
    phase of the packed loop is a ``repro_torch.trace`` span.  On a CUDA
    graph the final readback lands in reused page-locked host memory
    (``core.readback.PinnedPool``; its counts in ``readback_stats`` and
    ``last_stats["readback"]``); the rows handed back own their block.

    ``integrity`` (see ``INTEGRITY_MODES``) may be changed between waves;
    ``witness_k``/``witness_budget``/``integrity_seed`` shape the witness
    sample, drawn from ``np.random.default_rng(integrity_seed)`` as in the
    reference so both packages sample the same vertices.
    ``max_overflow_retries`` bounds the budget doublings of one wave
    (None = deepen forever) and raises ``BudgetOverflowError`` past it.
    """

    program: VertexProgram = BFS

    def __init__(self, g: LocalGraph, program: VertexProgram | None = None,
                 sched: SchedulerConfig | None = None,
                 init_budget: int = 1 << 15, use_kernels: bool | None = None,
                 max_overflow_retries: int | None = None,
                 tile_rows: int | None = None, sparse_pull: bool = False,
                 integrity: str = "off", witness_k: int = 64,
                 witness_budget: int = 4096,
                 integrity_seed: int | None = 0):
        if integrity not in INTEGRITY_MODES:
            raise ValueError(f"integrity must be one of {INTEGRITY_MODES}, "
                             f"got {integrity!r}")
        self.g = g
        self.program = program if program is not None else type(self).program
        self.sched = sched or SchedulerConfig()
        self.init_budget = init_budget
        self.use_kernels = resolve_use_kernels(g, use_kernels)
        self.integrity = integrity
        self.witness_k = witness_k
        self.witness_budget = witness_budget
        self._witness_rng = np.random.default_rng(integrity_seed)
        # exact-once plane corruption hook: (level, vertex, plane) XORs one
        # frontier bit right before that level's step; consumed per run
        self._corrupt_plane: tuple[int, int, int] | None = None
        # propagate kernel: None = auto (kernels.ops.propagate_plan),
        # 0 = whole-array, > 0 = row tiles
        self.tile_rows = tile_rows
        # budgeted pull on tail levels of the plain path (see
        # _propagate_pull_sparse); off keeps the dense scan's cost model
        self.sparse_pull = sparse_pull
        self.max_overflow_retries = max_overflow_retries
        self._transfers = 0
        self._readback = PinnedPool()
        self.last_stats: dict = {}
        self.last_level_seconds: list[float] = []
        # fetched once here so the TEPS accounting after each run is not
        # an extra (uncounted) device->host transfer
        self._out_deg_np = g.out_deg.cpu().numpy()[: g.n]

    # -- engine protocol --------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return int(self.g.n)

    @property
    def out_deg(self) -> np.ndarray:
        """Out-degrees [n] (the engine protocol's TEPS numerator input)."""
        return self._out_deg_np

    @property
    def readback_stats(self) -> dict:
        """The final readback's page-locked pool: ``PinnedPool.stats()``."""
        return self._readback.stats()

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One blocking device->host transfer: ``.cpu()``, or for the
        final readback admitted on a card the runner's reused page-locked
        blocks."""
        self._transfers += 1
        return self._readback.fetch(t)

    def _fetch_many(self, *ts: torch.Tensor) -> list[np.ndarray]:
        """The final readback: one blocking transfer for several tensors
        of one dtype.  They are written into one device buffer (a
        transposed view is transposed by that copy), travel in one copy
        and are split on the host, each C-contiguous.  The ``readback``
        span carries the pool's counts."""
        sizes = [t.numel() for t in ts]
        flat = torch.empty(sum(sizes), dtype=ts[0].dtype,
                           device=ts[0].device)
        for part, t in zip(flat.split(sizes), ts):
            part.view(t.shape).copy_(t)
        with span("readback", self._readback.admit(flat)):
            host = self._fetch(flat)
        return [a.reshape(t.shape) for a, t in
                zip(np.split(host, np.cumsum(sizes[:-1])), ts)]

    # -- integrity guards (active when ``integrity != "off"``) ------------
    def _guard_sv(self, sv: np.ndarray, lvl: int, nb: int,
                  discovered: int) -> None:
        """Host checks on the just-fetched statvec: the device residue
        slot, frontier-count/popcount agreement, the discovery-total bound
        and the termination bound.  Raises IntegrityError."""
        if int(sv[SV_CHECK]) != 0:
            raise IntegrityError(
                f"plane-word invariant violated at level {lvl}: "
                f"{int(sv[SV_CHECK])} corrupt frontier/seen/pad bits "
                "(frontier not a subset of seen, or dirty pad bits)")
        if (int(sv[SV_NF]) > 0) != (int(sv[SV_COUNT]) > 0):
            raise IntegrityError(
                f"statvec inconsistent at level {lvl}: frontier rows "
                f"{int(sv[SV_NF])} vs discovery popcount "
                f"{int(sv[SV_COUNT])}")
        if discovered + int(sv[SV_COUNT]) > self.g.n * nb:
            raise IntegrityError(
                f"cumulative discoveries {discovered + int(sv[SV_COUNT])} "
                f"exceed |V| x planes = {self.g.n * nb} at level {lvl} "
                "(each (vertex, plane) pair can be discovered once)")
        if lvl > self.g.n:
            raise IntegrityError(
                f"nonterminating traversal: level {lvl} exceeds |V| = "
                f"{self.g.n}")

    def _guard_rows(self, rows: np.ndarray, roots: np.ndarray,
                    iters: int) -> None:
        """Final value rows must be 0 at each plane's own root and either
        INF or bounded by the iteration count everywhere else."""
        bad = (rows != INF) & ((rows < 0) | (rows > iters))
        if bad.any():
            v = int(np.argwhere(bad)[0][1])
            raise IntegrityError(
                f"{int(bad.sum())} result values outside "
                f"[0, {iters}] or INF (first at vertex {v})")
        at_root = rows[np.arange(roots.size), roots]
        if np.any(at_root != 0):
            raise IntegrityError(
                f"{int(np.sum(at_root != 0))} planes lost their root "
                "(value at own root != 0)")

    def _pull_budget(self, m_u: int) -> int:
        """Sparse-pull budget for this level, or 0 to keep the dense scan
        (the next power of two above m_u, only well below the full CSC
        stream)."""
        cap = int(self.g.in_indices.shape[0])
        pb = 1 << max(12, (max(m_u, 1) - 1).bit_length())
        return pb if pb * 8 <= cap else 0

    def run(self, roots, *, budget: int | None = None) -> VertexProgramResult:
        """``budget`` overrides ``init_budget`` for this wave only."""
        # validate BEFORE the integer cast: a >= 2**31 root must error
        roots = validate_roots(np.asarray(roots), self.g.n).astype(np.int64)
        self._transfers = 0
        return self._finalize(self._run_packed(roots, budget), roots)

    def run_batch(self, roots, *, budget: int | None = None) -> np.ndarray:
        """Engine-protocol entry: value rows [B, n] + ``last_stats``."""
        return self.run(roots, budget=budget).levels

    def _finalize(self, res: VertexProgramResult,
                  roots: np.ndarray) -> VertexProgramResult:
        """Per-algorithm post-processing hook (CC labels)."""
        return res

    def _sync(self) -> None:
        if self.g.device.type == "cuda":
            torch.cuda.synchronize(self.g.device)

    def _run_packed(self, roots: np.ndarray,
                    budget_override: int | None = None
                    ) -> VertexProgramResult:
        g, program = self.g, self.program
        b = int(roots.size)
        check = self.integrity != "off"
        witness = self.integrity in ("witness", "audit")
        corrupt, self._corrupt_plane = self._corrupt_plane, None
        pcs: list[int] = []         # per-level discovery popcounts
        level_s: list[float] = []
        t0 = time.perf_counter()
        with span("init"):
            frontier, seen, value, statvec = vp_init_state(
                g, torch.from_numpy(roots).to(g.device), program, check=check)
            sv = self._fetch(statvec)
        if check:
            self._guard_sv(sv, 0, b, 0)
        pcs.append(int(sv[SV_COUNT]))
        mode = PUSH
        lvl = 0
        inspected = 0
        slots = 0                   # every step's budget, retries included
        push_iters = pull_iters = 0
        overflow_retries = 0
        # no point budgeting past the whole edge array; the overflow loop
        # still deepens
        budget = min(budget_override or self.init_budget,
                     max(g.out_indices.shape[0], g.in_indices.shape[0]) + 1)
        while not program.done(sv):
            t_lvl = time.perf_counter()
            with span("level", lvl):
                mode = choose_mode_host(self.sched, mode, int(sv[SV_NF]),
                                        int(sv[SV_MF]), int(sv[SV_MU]), g.n,
                                        int(sv[SV_NU]))
                # the plain dense pull scans the whole CSC stream: only
                # push and the budgeted kernel/sparse pulls need a budget
                budgeted = mode == PUSH or self.use_kernels
                step_budget = 0
                if budgeted:
                    need = int(sv[SV_MF]) if mode == PUSH else int(sv[SV_MU])
                    cap = (g.out_indices if mode == PUSH
                           else g.in_indices).shape[0]
                    while budget < min(need, cap + 1):
                        budget *= 2
                    step_budget = budget
                elif self.sparse_pull:
                    step_budget = self._pull_budget(int(sv[SV_MU]))
                step = vp_push_step if mode == PUSH else vp_pull_step
                if corrupt is not None and lvl == int(corrupt[0]):
                    # chaos hook: flip one frontier plane bit, exact-once
                    frontier = _xor_plane_bit(frontier, corrupt[1],
                                              corrupt[2])
                    corrupt = None
                # retry from the PRE-step state: steps never write inputs
                state0 = (frontier, seen, value)
                slots += step_budget
                with span("step"):
                    frontier, seen, value, statvec = step(
                        g, *state0, lvl, program, step_budget,
                        self.use_kernels, self.tile_rows, check)
                with span("statvec_fetch"):
                    sv = self._fetch(statvec)
                if check:
                    self._guard_sv(sv, lvl, b, sum(pcs))
                while step_budget and bool(sv[SV_OVERFLOW]):
                    overflow_retries += 1
                    if (self.max_overflow_retries is not None
                            and overflow_retries > self.max_overflow_retries):
                        raise BudgetOverflowError(
                            step_budget, int(sv[SV_MF]), overflow_retries)
                    step_budget *= 2   # HBM-reader queue overflow: deepen
                    if budgeted:
                        budget = step_budget
                    slots += step_budget
                    with span("retry"):
                        frontier, seen, value, statvec = step(
                            g, *state0, lvl, program, step_budget,
                            self.use_kernels, self.tile_rows, check)
                        sv = self._fetch(statvec)
                    if check:
                        self._guard_sv(sv, lvl, b, sum(pcs))
            pcs.append(int(sv[SV_COUNT]))
            lvl += 1
            inspected += int(sv[SV_TOTAL])
            if mode == PUSH:
                push_iters += 1
            else:
                pull_iters += 1
            level_s.append(time.perf_counter() - t_lvl)
        self._sync()
        dt = time.perf_counter() - t0
        # value rows, per-plane traversed-edge counts (each <= E, so int32
        # is safe) and, with the witness on, its int32[2] verdict come back
        # in ONE transfer, so host_transfers stays iterations + 2; the rows
        # are transposed on the device, so each arrives contiguous
        final = [value[: g.n].T, _plane_traversed(g, value)]
        if witness:
            k = min(self.witness_k, g.n)
            sample = torch.from_numpy(
                self._witness_rng.integers(0, g.n, size=k)).to(g.device)
            final.append(_witness_check(g, value, sample,
                                        self.witness_budget))
        rows, trav, *wit = self._fetch_many(*final)  # rows [B, n]
        wit = wit[0] if wit else None
        with span("count"):
            if check:
                self._guard_rows(rows, roots, lvl)
                if wit is not None and not int(wit[1]) and int(wit[0]):
                    raise IntegrityError(
                        f"witness audit failed: {int(wit[0])} sampled "
                        "(vertex, plane) discoveries have no in-neighbour "
                        "at value - 1")
            res = self._result(rows, b, lvl, inspected, push_iters,
                               pull_iters, dt, overflow_retries, budget,
                               trav)
        self.last_stats["discovery_popcounts"] = pcs
        self.last_stats["budget_slots"] = slots
        if check:
            self.last_stats["integrity"] = dict(
                mode=self.integrity, sv_checks=len(pcs),
                witness_sampled=(0 if wit is None
                                 else min(self.witness_k, g.n)),
                witness_truncated=bool(wit is not None and int(wit[1])))
        if self._readback.readbacks:
            self.last_stats["readback"] = self._readback.stats()
        self.last_level_seconds = level_s
        return res

    def _result(self, rows, b, lvl, inspected, push_iters, pull_iters, dt,
                overflow_retries: int = 0, budget: int = 0,
                trav_vec: np.ndarray | None = None) -> VertexProgramResult:
        if trav_vec is None:
            traversed = count_traversed_edges(self._out_deg_np, rows)
        else:
            traversed = int(np.sum(trav_vec, dtype=np.int64))
        res = VertexProgramResult(
            levels=rows, batch=b, iterations=lvl, edges_inspected=inspected,
            push_iters=push_iters, pull_iters=pull_iters,
            traversed_edges=traversed, seconds=dt,
            host_transfers=self._transfers, algo=self.program.name,
            overflow_retries=overflow_retries, budget=budget)
        self.last_stats = dict(
            iterations=res.iterations, edges_inspected=res.edges_inspected,
            push_iters=res.push_iters, pull_iters=res.pull_iters,
            batch=res.batch, traversed_edges=res.traversed_edges,
            seconds=res.seconds, host_transfers=res.host_transfers,
            algo=res.algo, overflow_retries=res.overflow_retries,
            budget=res.budget)
        if trav_vec is not None:
            self.last_stats["traversed_per_plane"] = [
                int(x) for x in trav_vec]
        return res


# ---------------------------------------------------------------------------
# Instantiation 1: batched multi-source BFS, plus the bool-plane baseline
# (``packed=False``: bool plane arrays, per-scalar syncs, P3 kernel K3).
# ---------------------------------------------------------------------------

def _p3_update_ms(cand_w, seen_w, use_kernels: bool):
    """Batched P3: kernel K3 on the [n_pad, nw] words as they are (its
    rows form: one launch, no transposes) or the plain body."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        new, seen, _ = kops.fused_frontier_update_rows(cand_w, seen_w)
        return new, seen
    new = cand_w & ~seen_w
    return new, seen_w | new


def _bool_scatter_planes(g: LocalGraph, fmask, src, tgt, valid):
    """cand[tgt[e], p] = OR over e of fmask[src[e], p]: the bool-plane
    scatter, as ``scatter_reduce("amax")`` on uint8 planes with a trash
    row (JAX's bool ``.at[].max(mode="drop")``).  Returns packed words."""
    nb = fmask.shape[1]
    msg = fmask[src.clamp(min=0).to(torch.int64)] & valid[:, None]
    rows = drop_index(torch.where(valid, tgt, -1), g.n_pad)
    cand = torch.zeros((g.n_pad + 1, nb), dtype=torch.uint8,
                       device=fmask.device)
    cand.scatter_reduce_(0, rows[:, None].expand(-1, nb),
                         msg.view(torch.uint8), "amax")
    return bitmap.pack_rows(cand[:-1].view(torch.bool))


def _boolplane_push_step(g: LocalGraph, frontier_w, seen_w, budget: int,
                         use_kernels: bool = False):
    """Bool-plane push: unpacks the whole frontier, builds a [budget, B]
    bool message array and an [n_pad + 1, B] scatter buffer per level."""
    fmask = bitmap.unpack_rows(frontier_w)            # [n_pad, B']
    src, nbr, valid, total = kef.expand_frontier(
        bitmap.any_rows(frontier_w), g.out_indptr, g.out_indices, budget)
    cand_w = _bool_scatter_planes(g, fmask, src, nbr, valid)
    new, seen2 = _p3_update_ms(cand_w, seen_w, use_kernels)
    return new, seen2, total, total > budget


def _boolplane_pull_step(g: LocalGraph, frontier_w, seen_w, budget: int,
                         use_kernels: bool = False):
    """Bool-plane pull: vertices unseen by SOME source read their in-lists
    once and OR their parents' frontier masks (via bool plane arrays)."""
    nb = frontier_w.shape[1] * bitmap.WORD_BITS
    fmask = bitmap.unpack_rows(frontier_w)
    child, parent, valid, total = kef.expand_frontier(
        _unseen_any(seen_w, nb), g.in_indptr, g.in_indices, budget)
    cand_w = _bool_scatter_planes(g, fmask, parent, child, valid)
    new, seen2 = _p3_update_ms(cand_w, seen_w, use_kernels)
    return new, seen2, total, total > budget


def _ms_iter_stats(g: LocalGraph, frontier_w, seen_w):
    nb = frontier_w.shape[1] * bitmap.WORD_BITS
    any_f = bitmap.any_rows(frontier_w)
    un_any = _unseen_any(seen_w, nb)
    zero = torch.zeros((), dtype=torch.int32, device=frontier_w.device)
    return (any_f.sum(dtype=torch.int32),
            torch.where(any_f, g.out_deg, zero).sum(dtype=torch.int32),
            torch.where(un_any, g.in_deg, zero).sum(dtype=torch.int32),
            un_any.sum(dtype=torch.int32))


class MultiSourceBFSRunner(VertexProgramRunner):
    """Batched hybrid MS-BFS: the BFS instantiation of the engine.

    ``packed=True`` (default) runs the shared packed-word pipeline.
    ``packed=False`` is the bool-plane baseline (bool planes + per-scalar
    syncs, the reference's "packed: off" arm); it performs no integrity
    checks, as in the reference, where it is the audit's yardstick.
    """

    program = BFS

    def __init__(self, g: LocalGraph, sched: SchedulerConfig | None = None,
                 init_budget: int = 1 << 15, use_kernels: bool | None = None,
                 packed: bool = True,
                 max_overflow_retries: int | None = None,
                 tile_rows: int | None = None, sparse_pull: bool = False,
                 integrity: str = "off", witness_k: int = 64,
                 witness_budget: int = 4096,
                 integrity_seed: int | None = 0):
        super().__init__(g, BFS, sched, init_budget, use_kernels,
                         max_overflow_retries, tile_rows, sparse_pull,
                         integrity, witness_k, witness_budget,
                         integrity_seed)
        self.packed = packed

    def run(self, roots, *, budget: int | None = None) -> VertexProgramResult:
        if self.packed:
            return super().run(roots, budget=budget)
        roots = validate_roots(np.asarray(roots), self.g.n).astype(np.int64)
        self._transfers = 0
        return self._run_boolplane(roots, budget)

    def _run_boolplane(self, roots: np.ndarray,
                       budget_override: int | None = None
                       ) -> VertexProgramResult:
        """Bool-plane driver: four stat fetches, a mode fetch, an
        overflow fetch per try and a total fetch per level, as in the
        reference (``host_transfers`` equal to its count)."""
        g = self.g
        b = int(roots.size)
        frontier, seen, level = plane_seed_init(
            g, torch.from_numpy(roots).to(g.device))
        mode = torch.tensor(PUSH, dtype=torch.int32, device=g.device)
        lvl = 0
        inspected = 0
        push_iters = pull_iters = 0
        overflow_retries = 0
        slots = 0
        budget = budget_override or self.init_budget
        t0 = time.perf_counter()
        while True:
            n_f, m_f, m_u, n_u = (self._fetch(x) for x in
                                  _ms_iter_stats(g, frontier, seen))
            if int(n_f) == 0:
                break
            mode = choose_mode(self.sched, mode, n_f, m_f, m_u, g.n, n_u)
            is_push = int(self._fetch(mode)) == PUSH
            step = (_boolplane_push_step if is_push
                    else _boolplane_pull_step)
            need = int(m_f) if is_push else int(m_u)
            while budget < min(need, g.out_indices.shape[0] + 1):
                budget *= 2
            seen0 = seen
            slots += budget
            new, seen, total, overflow = step(g, frontier, seen0, budget,
                                              self.use_kernels)
            while bool(self._fetch(overflow)):
                overflow_retries += 1
                if (self.max_overflow_retries is not None
                        and overflow_retries > self.max_overflow_retries):
                    raise BudgetOverflowError(budget, need, overflow_retries)
                budget *= 2
                slots += budget
                new, seen, total, overflow = step(g, frontier, seen0, budget,
                                                  self.use_kernels)
            level = level_commit(level, bitmap.unpack_rows(new, b), lvl)
            frontier = new
            lvl += 1
            inspected += int(self._fetch(total))
            if is_push:
                push_iters += 1
            else:
                pull_iters += 1
        self._sync()
        dt = time.perf_counter() - t0
        levels = self._fetch(level[: g.n]).T        # [B, n]
        res = self._result(levels, b, lvl, inspected, push_iters,
                           pull_iters, dt, overflow_retries, budget)
        self.last_stats["budget_slots"] = slots
        return res


# ---------------------------------------------------------------------------
# Instantiation 2: batched multi-seed connected components.
# ---------------------------------------------------------------------------

def component_labels(levels: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Per-vertex CC labels from the multi-seed reach levels: ``label[v]``
    is the smallest seed vertex id whose component contains ``v``, or -1
    when no seed reaches ``v``."""
    levels = np.asarray(levels)
    seeds = np.asarray(seeds, np.int64)
    reach = levels < INF                             # [B, n]
    big = np.iinfo(np.int64).max
    lab = np.where(reach, seeds[:, None], big).min(axis=0)
    return np.where(lab == big, -1, lab)


class ConnectedComponentsRunner(VertexProgramRunner):
    """Batched multi-seed CC: one plane per seed, flood fill to fixpoint.

    The engine must run over the SYMMETRIZED graph (components are an
    undirected notion): use :meth:`from_csr`, or a ``LocalGraph`` built
    from ``repro_torch.graph.symmetrize_csr`` output.  ``run(seeds)``
    returns hop levels from each seed ([B, n]; membership = ``level <
    INF``) plus ``result.labels`` (min seed id, -1 where no seed reaches).
    """

    program = CC

    @classmethod
    def from_csr(cls, csr, device=None, **kw) -> "ConnectedComponentsRunner":
        """Build from a (possibly directed) CSR on ``device`` (None = the
        CUDA card): symmetrize, then wire up."""
        from repro_torch.core.bfs_local import build_local_graph
        from repro_torch.graph.csr import symmetrize_csr, transpose_csr
        sym = symmetrize_csr(csr)
        return cls(build_local_graph(sym, transpose_csr(sym), device=device),
                   **kw)

    def _finalize(self, res: VertexProgramResult,
                  roots: np.ndarray) -> VertexProgramResult:
        res.labels = component_labels(res.levels, roots)
        self.last_stats["components"] = int(
            np.unique(res.labels[res.labels >= 0]).size)
        return res


# ---------------------------------------------------------------------------
# Instantiation 3: batched SSSP (unit-weight hop distances).
# ---------------------------------------------------------------------------

class SSSPRunner(VertexProgramRunner):
    """Batched single-source shortest paths, unit edge weights: one
    frontier plane per source, a min-plus relaxation as the apply.
    ``result.distances`` ([B, n], INF = unreachable) aliases the value
    rows."""

    program = SSSP
