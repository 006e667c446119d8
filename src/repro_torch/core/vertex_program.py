"""Batched vertex-program engine: the packed MS-BFS pipeline (PyTorch port
of the BFS half of ``repro.core.vertex_program``).

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

Not ported yet (raise ``NotImplementedError``): the bool-plane baseline
(``packed=False``), integrity checking, CC and SSSP.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bitmap
from repro_torch.core.bfs_local import (INF, SV_COUNT, SV_MF, SV_MU, SV_NF,
                                        SV_NU, SV_OVERFLOW, SV_TOTAL,
                                        LocalGraph, compact_indices,
                                        expand_edges, validate_roots)
from repro_torch.core.scheduler import PUSH, SchedulerConfig, choose_mode_host


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


def frontier_drained(sv: np.ndarray) -> bool:
    """Convergence predicate: no plane produced a new discovery."""
    return int(sv[SV_NF]) == 0


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Per-algorithm bundle plugged into the shared engine."""

    name: str
    init: Callable = plane_seed_init
    commit: Callable = level_commit
    done: Callable = frontier_drained
    combine: str = "or"          # plane merge op (see kernels.ops)


BFS = VertexProgram(name="bfs")


# ---------------------------------------------------------------------------
# Shared packed-plane machinery
# ---------------------------------------------------------------------------

def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _vp_statvec(g: LocalGraph, new_w, seen_w, total, overflow, nb: int):
    """Fused per-level stats: scheduler inputs for the NEXT level, this
    step's edge total/overflow and the discovery popcount, stacked into
    one int32[7] so the driver fetches a single tensor per level.

    ``nb`` is the TRUE batch size: the pad planes of the last word are
    unseen by construction and must be masked out."""
    dev = new_w.device
    pmask = bitmap.plane_mask(nb, dev)
    any_f = bitmap.any_rows(new_w)
    un_any = bitmap.any_rows(~seen_w & pmask)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return torch.stack([
        any_f.sum(dtype=torch.int32),
        torch.where(any_f, g.out_deg, zero).sum(dtype=torch.int32),
        torch.where(un_any, g.in_deg, zero).sum(dtype=torch.int32),
        un_any.sum(dtype=torch.int32),
        _as_i32(total, dev),
        _as_i32(overflow, dev),
        bitmap.popcount(new_w),
    ])


def _vp_commit(g: LocalGraph, program: VertexProgram, new_w, seen_w, value,
               lvl, total, overflow):
    """Per-level apply (the pipeline's single unpack point) + fused stats."""
    new_mask = bitmap.unpack_rows(new_w, value.shape[1])
    value2 = program.commit(value, new_mask, lvl)
    return value2, _vp_statvec(g, new_w, seen_w, total, overflow,
                               value.shape[1])


def _propagate_edges(g: LocalGraph, frontier_w, seen_w, src, tgt, valid,
                     use_kernels: bool, combine: str = "or",
                     tile_rows: int | None = None):
    """Fused P2->P3 on packed words: cand[tgt] (+)= frontier[src], then
    new = cand & ~seen, seen |= new.  Kernel path (``kernels.ops``) or the
    plain scatter-OR.  ``tile_rows`` selects the kernel (None = auto by
    plane-array footprint, 0 = whole-array, > 0 = row-tiled)."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        new, seen2, _ = kops.msbfs_propagate(frontier_w, seen_w, src, tgt,
                                             valid, op=combine,
                                             tile_rows=tile_rows)
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


def vp_init_state(g: LocalGraph, roots: torch.Tensor, program: VertexProgram):
    frontier, seen, value = program.init(g, roots)
    return (frontier, seen, value,
            _vp_statvec(g, frontier, seen, 0, 0, roots.shape[0]))


def push_edges(g: LocalGraph, frontier_w, budget: int):
    """The push step's budgeted edge list: out-lists of any-plane frontier
    vertices.  Returns (src, tgt, valid, total)."""
    active, _ = compact_indices(bitmap.any_rows(frontier_w), g.n_pad)
    return expand_edges(active, g.out_indptr, g.out_indices, budget)


def pull_edges(g: LocalGraph, seen_w, nb: int, budget: int):
    """The kernel pull's budgeted edge list: in-lists of some-plane-unseen
    vertices, as (src=parent, tgt=child, valid, total)."""
    active, _ = compact_indices(_unseen_any(seen_w, nb), g.n_pad)
    child, parent, valid, total = expand_edges(active, g.in_indptr,
                                               g.in_indices, budget)
    return parent, child, valid, total


def vp_push_step(g: LocalGraph, frontier_w, seen_w, value, lvl,
                 program: VertexProgram, budget: int,
                 use_kernels: bool = False, tile_rows: int | None = None):
    """Batched push on packed words: each budgeted out-edge carries its
    endpoint's packed plane word into the candidate planes (fused
    P2->P3).  Returns (new, seen2, value2, statvec); inputs are never
    written."""
    src, nbr, valid, total = push_edges(g, frontier_w, budget)
    new, seen2 = _propagate_edges(g, frontier_w, seen_w, src, nbr, valid,
                                  use_kernels, program.combine, tile_rows)
    value2, statvec = _vp_commit(g, program, new, seen2, value, lvl, total,
                                 total > budget)
    return new, seen2, value2, statvec


def vp_pull_step(g: LocalGraph, frontier_w, seen_w, value, lvl,
                 program: VertexProgram, budget: int = 0,
                 use_kernels: bool = False, tile_rows: int | None = None):
    """Batched pull on packed words.

    Kernel path: budgeted expansion of the some-plane-unseen in-lists
    through the fused propagate.  Plain path: ``budget == 0`` is the dense
    segmented OR over the whole CSC stream (never overflows), ``budget >
    0`` the sparse budgeted pull of tail levels."""
    nb = value.shape[1]
    if use_kernels:
        parent, child, valid, total = pull_edges(g, seen_w, nb, budget)
        new, seen2 = _propagate_edges(g, frontier_w, seen_w, parent, child,
                                      valid, True, program.combine,
                                      tile_rows)
        overflow = total > budget
    elif budget:
        new, seen2, total = _propagate_pull_sparse(g, frontier_w, seen_w, nb,
                                                   budget)
        overflow = total > budget
    else:
        cand = _propagate_pull_scan(g, frontier_w)
        new = cand & ~seen_w
        seen2 = seen_w | new
        total = int(g.in_indices.shape[0])
        overflow = 0
    value2, statvec = _vp_commit(g, program, new, seen2, value, lvl, total,
                                 overflow)
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
    overflow_retries: int = 0   # levels re-run after a truncated push/pull
    budget: int = 0             # final edge budget the run settled on

    @property
    def aggregate_teps(self) -> float:
        return self.traversed_edges / max(self.seconds, 1e-12)

    @property
    def gteps(self) -> float:
        return self.aggregate_teps / 1e9


def resolve_use_kernels(g: LocalGraph, use_kernels: bool | None) -> bool:
    """None -> kernels iff the graph is on CUDA; False on CUDA raises."""
    on_cuda = g.device.type == "cuda"
    if use_kernels is None:
        return on_cuda
    if on_cuda and not use_kernels:
        raise ValueError("use_kernels=False is a CPU path only; a graph on "
                         "CUDA runs the propagate kernels")
    return bool(use_kernels)


class VertexProgramRunner:
    """Python-driven hybrid vertex-program engine over a batch of roots.

    Per level: stats -> mode -> gather/scan step -> commit, one bit-plane
    per root, with exactly one blocking device->host transfer (the fused
    statvec): ``result.host_transfers == iterations + 2``.  ``run`` is the
    shared entry and validates the roots once.

    After a run, ``last_stats`` holds the reference's counters and
    ``last_level_seconds`` the host time of each level (step + statvec
    fetch; the fetch synchronises, so it covers the device work).
    """

    program: VertexProgram = BFS

    def __init__(self, g: LocalGraph, program: VertexProgram | None = None,
                 sched: SchedulerConfig | None = None,
                 init_budget: int = 1 << 15, use_kernels: bool | None = None,
                 tile_rows: int | None = None, sparse_pull: bool = False,
                 integrity: str = "off"):
        if integrity != "off":
            raise NotImplementedError(
                "integrity checking is not ported yet (integrity='off')")
        self.g = g
        self.program = program if program is not None else type(self).program
        if self.program.name != "bfs":
            raise NotImplementedError(
                f"vertex program {self.program.name!r} is not ported yet")
        self.sched = sched or SchedulerConfig()
        self.init_budget = init_budget
        self.use_kernels = resolve_use_kernels(g, use_kernels)
        # propagate kernel: None = auto by plane-array footprint
        # (kernels.ops.propagate_plan), 0 = whole-array, > 0 = row tiles
        self.tile_rows = tile_rows
        # budgeted pull on tail levels of the plain path (see
        # _propagate_pull_sparse); off keeps the dense scan's cost model
        self.sparse_pull = sparse_pull
        self._transfers = 0
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

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One blocking device->host transfer."""
        self._transfers += 1
        return t.cpu().numpy()

    def _pull_budget(self, m_u: int) -> int:
        """Sparse-pull budget for this level, or 0 to keep the dense scan
        (the next power of two above m_u, only well below the full CSC
        stream)."""
        cap = int(self.g.in_indices.shape[0])
        pb = 1 << max(12, (max(m_u, 1) - 1).bit_length())
        return pb if pb * 8 <= cap else 0

    def run(self, roots) -> VertexProgramResult:
        # validate BEFORE the integer cast: a >= 2**31 root must error
        roots = validate_roots(np.asarray(roots), self.g.n).astype(np.int64)
        self._transfers = 0
        return self._run_packed(roots)

    def run_batch(self, roots) -> np.ndarray:
        """Engine-protocol entry: value rows [B, n] + ``last_stats``."""
        return self.run(roots).levels

    def _sync(self) -> None:
        if self.g.device.type == "cuda":
            torch.cuda.synchronize(self.g.device)

    def _run_packed(self, roots: np.ndarray) -> VertexProgramResult:
        g, program = self.g, self.program
        b = int(roots.size)
        pcs: list[int] = []         # per-level discovery popcounts
        level_s: list[float] = []
        t0 = time.perf_counter()
        frontier, seen, value, statvec = vp_init_state(
            g, torch.from_numpy(roots).to(g.device), program)
        sv = self._fetch(statvec)
        pcs.append(int(sv[SV_COUNT]))
        mode = PUSH
        lvl = 0
        inspected = 0
        push_iters = pull_iters = 0
        overflow_retries = 0
        # no point budgeting past the whole edge array; the overflow loop
        # still deepens
        budget = min(self.init_budget,
                     max(g.out_indices.shape[0], g.in_indices.shape[0]) + 1)
        while not program.done(sv):
            t_lvl = time.perf_counter()
            mode = choose_mode_host(self.sched, mode, int(sv[SV_NF]),
                                    int(sv[SV_MF]), int(sv[SV_MU]), g.n,
                                    int(sv[SV_NU]))
            # the plain dense pull scans the whole CSC stream: only push
            # and the budgeted kernel/sparse pulls need a budget
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
            # retry from the PRE-step state: steps never write their inputs
            state0 = (frontier, seen, value)
            frontier, seen, value, statvec = step(
                g, *state0, lvl, program, step_budget, self.use_kernels,
                self.tile_rows)
            sv = self._fetch(statvec)
            while step_budget and bool(sv[SV_OVERFLOW]):
                overflow_retries += 1
                step_budget *= 2       # HBM-reader queue overflow: deepen
                if budgeted:
                    budget = step_budget
                frontier, seen, value, statvec = step(
                    g, *state0, lvl, program, step_budget, self.use_kernels,
                    self.tile_rows)
                sv = self._fetch(statvec)
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
        # value rows and per-plane traversed-edge counts come back in ONE
        # transfer (stacked as one extra row), so host_transfers stays
        # iterations + 2.  Each plane's count is <= E, so int32 is safe.
        both = self._fetch(torch.cat([value[: g.n],
                                      _plane_traversed(g, value)[None]]))
        rows, trav = both[:-1].T, both[-1]           # [B, n], [B]
        res = self._result(rows, b, lvl, inspected, push_iters, pull_iters,
                           dt, overflow_retries, budget, trav)
        self.last_stats["discovery_popcounts"] = pcs
        self.last_level_seconds = level_s
        return res

    def _result(self, rows, b, lvl, inspected, push_iters, pull_iters, dt,
                overflow_retries: int, budget: int,
                trav_vec: np.ndarray) -> VertexProgramResult:
        res = VertexProgramResult(
            levels=rows, batch=b, iterations=lvl, edges_inspected=inspected,
            push_iters=push_iters, pull_iters=pull_iters,
            traversed_edges=int(np.sum(trav_vec, dtype=np.int64)),
            seconds=dt, host_transfers=self._transfers,
            algo=self.program.name, overflow_retries=overflow_retries,
            budget=budget)
        self.last_stats = dict(
            iterations=res.iterations, edges_inspected=res.edges_inspected,
            push_iters=res.push_iters, pull_iters=res.pull_iters,
            batch=res.batch, traversed_edges=res.traversed_edges,
            seconds=res.seconds, host_transfers=res.host_transfers,
            algo=res.algo, overflow_retries=res.overflow_retries,
            budget=res.budget,
            traversed_per_plane=[int(x) for x in trav_vec])
        return res


class MultiSourceBFSRunner(VertexProgramRunner):
    """Batched hybrid MS-BFS: the BFS instantiation of the engine.

    ``packed=False`` (the reference's bool-plane baseline) is not ported
    yet and raises ``NotImplementedError``.
    """

    program = BFS

    def __init__(self, g: LocalGraph, sched: SchedulerConfig | None = None,
                 init_budget: int = 1 << 15, use_kernels: bool | None = None,
                 packed: bool = True, tile_rows: int | None = None,
                 sparse_pull: bool = False, integrity: str = "off"):
        if not packed:
            raise NotImplementedError(
                "the bool-plane baseline (packed=False) is not ported yet")
        super().__init__(g, BFS, sched, init_budget, use_kernels, tile_rows,
                         sparse_pull, integrity)
        self.packed = packed
