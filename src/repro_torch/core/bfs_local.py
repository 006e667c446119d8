"""Single-device BFS (paper Algorithm 2) and the shared primitives of
the batched engine: PyTorch port of ``repro.core.bfs_local``.

``LocalGraph`` (device tensors), the static-cap frontier compaction (P1),
the budgeted neighbour expansion (P2 gather), the ``SV_*`` statvec layout,
root validation, the TEPS numerator and the pure-Python oracle; and the
single-source pipeline: ``bfs_reference`` (dense edge-parallel steps) and
``BFSRunner``, the paper's per-root GTEPS engine, whose push and pull
steps end in the fused P3 update (kernel K4 under ``use_kernels``).

No device function here reads a tensor's value on the host: sizes come
from Python ints (caps and budgets), so the runners keep their
one-fetch-per-level protocol.  The steps' P1 + P2 is
``kernels.expand_frontier``: on a CUDA graph hand-written kernels that
wait for nothing on the host, on the CPU ``compact_indices`` +
``expand_edges``.  One call still waits for the stream, as a
host-to-device copy of a Python scalar does: ``bitmap.from_indices_dense``'s
``dense[...] = True`` in ``BFSRunner``'s steps (the ``syncs_per_level``
metrics count it); the plain ``expand_edges``' ``torch.tensor(-1,
device=...)`` runs on the CPU only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import bitmap
from repro_torch.core.readback import PinnedPool
from repro_torch.core.scheduler import PUSH, SchedulerConfig, choose_mode_host
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph, edge_sources
from repro_torch.kernels import expand_frontier as kef
from repro_torch.trace import span

INF = 1 << 30

# Layout of the per-level fused stats vector (int32[7]) every step returns:
# next-frontier stats for the Scheduler, this step's edge total + overflow
# flag, and the new-discovery popcount — ONE device->host transfer per level.
SV_NF, SV_MF, SV_MU, SV_NU, SV_TOTAL, SV_OVERFLOW, SV_COUNT = range(7)


@dataclasses.dataclass(frozen=True)
class LocalGraph:
    """Device-resident graph tensors (vertex space padded to words).

    Index tensors are int32 (graphs up to 2**31 edges), as in the
    reference; ``in_seg_first`` is bool.
    """

    n: int
    n_pad: int
    out_indptr: torch.Tensor    # int32[n_pad+1]
    out_indices: torch.Tensor   # int32[E]
    in_indptr: torch.Tensor
    in_indices: torch.Tensor
    out_src: torch.Tensor       # int32[E] edge-parallel CSR sources
    in_child: torch.Tensor      # int32[E] edge-parallel CSC rows (children)
    out_deg: torch.Tensor       # int32[n_pad] stored out-degrees
    in_deg: torch.Tensor        # int32[n_pad] stored in-degrees
    in_seg_first: torch.Tensor  # bool[E]  e starts a child's in-list
    in_seg_end: torch.Tensor    # int32[n_pad] last in-edge per child (-1: none)

    @property
    def device(self) -> torch.device:
        return self.out_indptr.device


FIELDS = ("out_indptr", "out_indices", "in_indptr", "in_indices", "out_src",
          "in_child", "out_deg", "in_deg", "in_seg_first", "in_seg_end")


def local_graph_arrays(csr: CSRGraph, csc: CSRGraph) -> dict:
    """The numpy arrays of every ``LocalGraph`` field (host side)."""
    n = csr.num_vertices
    n_pad = bitmap.num_words(n) * bitmap.WORD_BITS

    def pad_ptr(indptr):
        return np.concatenate(
            [indptr, np.full(n_pad - n, indptr[-1], dtype=indptr.dtype)])

    out_ptr = pad_ptr(csr.indptr)
    in_ptr = pad_ptr(csc.indptr)
    in_deg = np.diff(in_ptr)
    e_in = int(csc.indices.shape[0])
    in_first = np.zeros(e_in, dtype=bool)
    in_first[in_ptr[:-1][in_deg > 0]] = True
    in_end = np.where(in_deg > 0, in_ptr[1:] - 1, -1)
    return dict(
        out_indptr=out_ptr.astype(np.int32),
        out_indices=np.asarray(csr.indices, np.int32),
        in_indptr=in_ptr.astype(np.int32),
        in_indices=np.asarray(csc.indices, np.int32),
        out_src=edge_sources(csr),
        in_child=edge_sources(csc),
        out_deg=np.diff(out_ptr).astype(np.int32),
        in_deg=in_deg.astype(np.int32),
        in_seg_first=in_first,
        in_seg_end=in_end.astype(np.int32),
    )


def build_local_graph(csr: CSRGraph, csc: CSRGraph,
                      device=None) -> LocalGraph:
    """Move a CSR/CSC pair to ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    n = csr.num_vertices
    arrays = local_graph_arrays(csr, csc)
    return LocalGraph(
        n=n, n_pad=bitmap.num_words(n) * bitmap.WORD_BITS,
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


def compact_indices(mask: torch.Tensor, cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """P1 workload prep: indices of set bits, padded with -1 to ``cap``.

    A static-cap cumsum compaction (``torch.nonzero`` has a data-dependent
    shape and synchronises with the host).  Set bits beyond ``cap`` are
    dropped, like ``jnp.nonzero(size=cap)``.  Returns (int32[cap], count).
    """
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return out[:cap], mask.sum(dtype=torch.int32)


def expand_edges(active: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, budget: int):
    """P2 neighbor gather: flatten the neighbor lists of ``active`` vertices.

    Returns (sources, neighbors, valid, total_edges), the first two int32
    [budget] with -1 in invalid slots.  ``total_edges`` (a device scalar)
    may exceed ``budget``: the caller must treat that as overflow and
    retry with a bigger budget (the HBM-reader queue depth analogue).
    """
    dev = active.device
    a = active.clamp(min=0).to(torch.int64)
    deg = ((indptr[a + 1] - indptr[a]) * (active >= 0)).to(torch.int64)
    cum = torch.cumsum(deg, 0)
    total = cum[-1].to(torch.int32)
    e = torch.arange(budget, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(cum, e, right=True)
    owner_c = owner.clamp(max=active.shape[0] - 1)
    start = cum[owner_c] - deg[owner_c]
    src = active[owner_c]
    valid = e < cum[-1]
    if indices.shape[0] == 0:
        nbr = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    else:
        eidx = indptr[src.clamp(min=0).to(torch.int64)].to(torch.int64) \
            + (e - start)
        nbr = indices[torch.where(valid, eidx, 0)]
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    return (torch.where(valid, src, minus1),
            torch.where(valid, nbr, minus1), valid, total)


def resolve_use_kernels(g: LocalGraph, use_kernels: bool | None) -> bool:
    """None -> kernels iff the graph is on CUDA; False on CUDA raises (the
    plain path, the reference's jnp fallback, is a CPU path only)."""
    on_cuda = g.device.type == "cuda"
    if use_kernels is None:
        return on_cuda
    if on_cuda and not use_kernels:
        raise ValueError("use_kernels=False is a CPU path only; a graph on "
                         "CUDA runs the kernels")
    return bool(use_kernels)


# ---------------------------------------------------------------------------
# Dense (edge-parallel) steps: O(E) work, the single-source reference.
# ---------------------------------------------------------------------------

def _dense_step(g: LocalGraph, frontier_w, visited_w):
    """One level expansion; returns candidate bitmap words (global)."""
    fmask = bitmap.unpack(frontier_w, g.n_pad)
    msg = fmask[g.out_src.to(torch.int64)].to(torch.uint8)
    cand = torch.zeros(g.n_pad, dtype=torch.uint8, device=msg.device)
    cand.scatter_reduce_(0, g.out_indices.to(torch.int64), msg, "amax")
    return bitmap.pack(cand.to(torch.bool))


def bfs_reference(g: LocalGraph, root: int, max_iters: int | None = None):
    """Algorithm 2 loop with dense steps.  Returns level int32[n] on the
    graph's device (the loop condition reads the device every level)."""
    max_iters = max_iters or g.n_pad
    frontier = bitmap.from_indices_dense(
        torch.tensor([root], device=g.device), g.n_pad)
    visited = frontier
    level = torch.full((g.n_pad,), INF, dtype=torch.int32, device=g.device)
    level[root] = 0
    lvl = 0
    while lvl < max_iters and int(bitmap.popcount(frontier)) > 0:
        cand = _dense_step(g, frontier, visited)
        new = cand & ~visited                 # P3: next |= cand & ~visited
        visited = visited | new
        level = torch.where(bitmap.unpack(new, g.n_pad), lvl + 1, level)
        frontier = new
        lvl += 1
    return level[: g.n]


# ---------------------------------------------------------------------------
# Work-efficient gather pipeline (P1 -> P2 -> P3), mirroring the PE stages.
# ---------------------------------------------------------------------------

def _p3_update(cand_w, visited_w, use_kernels: bool, out=None):
    """P3 result writing: kernel K4 (``kernels.ops``, into ``out`` when
    given) or the plain body.  Returns (new, visited, count): K4's int32
    scalar popcount of ``new``, None on the plain path."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.fused_frontier_update(cand_w, visited_w, out=out)
    new = cand_w & ~visited_w
    return new, visited_w | new, None


def _statvec(g: LocalGraph, new_w, visited_w, total, overflow, count=None):
    """Fused per-level stats (single-source): one stacked int32[7].
    ``count``: popcount(new_w) when the caller has it (K4's), which is
    both ``SV_NF`` and ``SV_COUNT``."""
    dev = new_w.device
    fmask = bitmap.unpack(new_w, g.n_pad)
    umask = ~bitmap.unpack(visited_w, g.n_pad)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if count is None:
        count = bitmap.popcount(new_w)
    return torch.stack([
        count,
        torch.where(fmask, g.out_deg, zero).sum(dtype=torch.int32),
        torch.where(umask, g.in_deg, zero).sum(dtype=torch.int32),
        umask.sum(dtype=torch.int32),
        torch.as_tensor(total, device=dev).to(torch.int32),
        torch.as_tensor(overflow, device=dev).to(torch.int32),
        count,
    ])


def _sbfs_init(g: LocalGraph, roots: torch.Tensor):
    frontier = bitmap.from_indices_dense(roots, g.n_pad)
    level = torch.full((g.n_pad,), INF, dtype=torch.int32, device=g.device)
    level[roots[0]] = 0
    return frontier, frontier, level, _statvec(g, frontier, frontier, 0, 0)


def push_step(g: LocalGraph, frontier_w, visited_w, level, lvl: int,
              budget: int, use_kernels: bool = False, out=None):
    """Push iteration: expand out-lists of frontier, filter by visited.

    Level update and next-level stats are folded in; returns (new,
    visited, level, statvec); the driver fetches only ``statvec``.
    Inputs are never written; ``out`` (K4's buffers, see
    ``kernels.bitmap_update``) must not hold them."""
    with span("expand"):
        _, nbr, valid, total = kef.expand_frontier(
            bitmap.unpack(frontier_w, g.n_pad), g.out_indptr, g.out_indices,
            budget)
    with span("propagate"):
        unvisited = ~bitmap.test_bits(visited_w, nbr.clamp(min=0)) & valid
        cand = bitmap.from_indices_dense(torch.where(unvisited, nbr, -1),
                                         g.n_pad)
    return _commit(g, cand, visited_w, level, lvl, total, budget,
                   use_kernels, out)


def pull_step(g: LocalGraph, frontier_w, visited_w, level, lvl: int,
              budget: int, use_kernels: bool = False, out=None):
    """Pull iteration: expand in-lists of unvisited, test frontier bit."""
    with span("expand"):
        child, parent, valid, total = kef.expand_frontier(
            ~bitmap.unpack(visited_w, g.n_pad), g.in_indptr, g.in_indices,
            budget)
    with span("propagate"):
        hit = bitmap.test_bits(frontier_w, parent.clamp(min=0)) & valid
        cand = bitmap.from_indices_dense(torch.where(hit, child, -1),
                                         g.n_pad)
    return _commit(g, cand, visited_w, level, lvl, total, budget,
                   use_kernels, out)


def _commit(g: LocalGraph, cand, visited_w, level, lvl: int, total,
            budget: int, use_kernels: bool, out):
    """Both steps' tail: P3 and the level update, then the statvec."""
    with span("commit"):
        new, vis2, count = _p3_update(cand, visited_w, use_kernels, out)
        level2 = torch.where(bitmap.unpack(new, g.n_pad), lvl + 1, level)
    with span("statvec"):
        sv = _statvec(g, new, vis2, total, total > budget, count)
    return new, vis2, level2, sv


@dataclasses.dataclass
class BFSResult:
    level: np.ndarray
    iterations: int
    edges_inspected: int
    push_iters: int
    pull_iters: int
    traversed_edges: int
    seconds: float
    host_transfers: int = 0     # blocking device->host fetches during run
    overflow_retries: int = 0   # levels re-run after a truncated step

    @property
    def gteps(self) -> float:
        return self.traversed_edges / max(self.seconds, 1e-12) / 1e9


class BFSRunner:
    """Python-driven hybrid BFS with budgeted gather steps (the paper's
    per-root GTEPS engine).

    One-sync-per-level driver: every step returns its successor's stats
    as a stacked int32[7], so the loop makes exactly one blocking
    device->host transfer per level, one per overflow retry, plus one
    for the initial frontier and one final level-array readback.
    ``use_kernels`` takes the reference's ``use_pallas`` place (see
    :func:`resolve_use_kernels`).  After a run ``last_level_seconds``
    holds the host time of each level (step + statvec fetch, retries
    included; the fetch synchronises, so it covers the device work).
    Each phase is a ``repro_torch.trace`` span.  On a CUDA graph the level
    array lands in reused page-locked host memory (``core.readback.
    PinnedPool``; its counts in ``readback_stats``).
    """

    def __init__(self, g: LocalGraph, sched: SchedulerConfig | None = None,
                 init_budget: int = 1 << 15, use_kernels: bool | None = None):
        self.g = g
        self.sched = sched or SchedulerConfig()
        self.init_budget = init_budget
        self.use_kernels = resolve_use_kernels(g, use_kernels)
        self._transfers = 0
        self._readback = PinnedPool()
        self.last_level_seconds: list[float] = []
        # fetched once here so the GTEPS accounting after each run is not
        # an extra (uncounted) device->host transfer
        self._out_deg_np = g.out_deg.cpu().numpy()[: g.n]
        # K4's two output sets (new, visited, count): level k writes set
        # k % 2 and reads the other, so a level allocates nothing for P3
        # and a retry, which rewrites the same set, never writes its inputs
        self._p3_out = None
        if self.use_kernels:
            w = g.n_pad // bitmap.WORD_BITS
            self._p3_out = [tuple(
                torch.empty(shape, dtype=torch.int32, device=g.device)
                for shape in ((w,), (w,), (1, 1))) for _ in range(2)]

    @property
    def num_vertices(self) -> int:
        return int(self.g.n)

    @property
    def out_deg(self) -> np.ndarray:
        """Out-degrees [n] (the engine protocol's TEPS numerator input)."""
        return self._out_deg_np

    @property
    def readback_stats(self) -> dict:
        """The level array's page-locked pool: ``PinnedPool.stats()``."""
        return self._readback.stats()

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One blocking device->host transfer: ``.cpu()``, or for the
        level array admitted on a card the runner's reused page-locked
        blocks."""
        self._transfers += 1
        return self._readback.fetch(t)

    def run(self, root: int) -> BFSResult:
        g = self.g
        root = int(validate_roots(np.asarray([root]), g.n)[0])
        self._transfers = 0
        level_s: list[float] = []
        t0 = time.perf_counter()
        with span("init"):
            frontier, visited, level, statvec = _sbfs_init(
                g, torch.tensor([root], device=g.device))
            sv = self._fetch(statvec)
        mode = PUSH
        lvl = 0
        inspected = 0
        push_iters = pull_iters = 0
        overflow_retries = 0
        # no point budgeting past the whole edge array; the overflow loop
        # still deepens
        budget = min(self.init_budget,
                     max(g.out_indices.shape[0], g.in_indices.shape[0]) + 1)
        while int(sv[SV_NF]) > 0:
            t_lvl = time.perf_counter()
            with span("level", lvl):
                mode = choose_mode_host(self.sched, mode, int(sv[SV_NF]),
                                        int(sv[SV_MF]), int(sv[SV_MU]), g.n,
                                        int(sv[SV_NU]))
                step = push_step if mode == PUSH else pull_step
                need = int(sv[SV_MF]) if mode == PUSH else int(sv[SV_MU])
                cap = (g.out_indices if mode == PUSH
                       else g.in_indices).shape[0]
                while budget < min(need, cap + 1):
                    budget *= 2
                # retry from the PRE-step state: steps never write inputs
                state0 = (frontier, visited, level)
                out = self._p3_out[lvl % 2] if self._p3_out else None
                with span("step"):
                    frontier, visited, level, statvec = step(
                        g, *state0, lvl, budget, self.use_kernels, out)
                with span("statvec_fetch"):
                    sv = self._fetch(statvec)
                while bool(sv[SV_OVERFLOW]):  # HBM-reader overflow: deepen
                    overflow_retries += 1
                    budget *= 2
                    with span("retry"):
                        frontier, visited, level, statvec = step(
                            g, *state0, lvl, budget, self.use_kernels, out)
                        sv = self._fetch(statvec)
            level_s.append(time.perf_counter() - t_lvl)
            lvl += 1
            inspected += int(sv[SV_TOTAL])
            if mode == PUSH:
                push_iters += 1
            else:
                pull_iters += 1
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)
        dt = time.perf_counter() - t0
        self.last_level_seconds = level_s
        level = level[: g.n]
        with span("readback", self._readback.admit(level)):
            level_np = self._fetch(level)
        # GTEPS metric per paper §VI-A: sum of outgoing neighbor-list
        # lengths of all visited vertices; each edge counted once.
        with span("count"):
            traversed = count_traversed_edges(self._out_deg_np, level_np)
        return BFSResult(level=level_np, iterations=lvl,
                         edges_inspected=inspected, push_iters=push_iters,
                         pull_iters=pull_iters, traversed_edges=traversed,
                         seconds=dt, host_transfers=self._transfers,
                         overflow_retries=overflow_retries)


@runtime_checkable
class BFSEngine(Protocol):
    """Minimal contract the serving layer relies on: the number of
    vertices of the resident graph, its out-degrees (the TEPS numerator),
    and ``run_batch(roots)`` returning value rows [B, n] with per-run
    counters in ``last_stats``."""

    @property
    def num_vertices(self) -> int: ...

    @property
    def out_deg(self) -> "np.ndarray | None": ...

    def run_batch(self, roots) -> np.ndarray: ...


def validate_roots(roots: np.ndarray, num_vertices: int) -> np.ndarray:
    """Reject malformed MS-BFS root batches with a ``ValueError``.

    A negative or >= |V| root would index out of bounds (a wrapped row on
    the CPU, a device fault on CUDA).  Duplicate roots ARE allowed — each
    occupies its own bit-plane slot and resolves independently.
    """
    roots = np.asarray(roots)
    if roots.ndim != 1 or roots.size == 0:
        raise ValueError(
            f"roots must be a non-empty 1-D array, got shape {roots.shape}")
    if not np.issubdtype(roots.dtype, np.integer):
        raise ValueError(f"roots must be integers, got dtype {roots.dtype}")
    if ((roots < 0) | (roots >= num_vertices)).any():
        bad = roots[(roots < 0) | (roots >= num_vertices)]
        raise ValueError(
            f"roots out of range [0, {num_vertices}): {bad.tolist()[:8]}")
    return roots


def engine_num_vertices(engine) -> int | None:
    """|V| of the graph a BFS engine serves, or None (protocol first,
    then the ``.g`` duck-typing of older wrapper engines)."""
    n = getattr(engine, "num_vertices", None)
    if n is not None:
        return int(n)
    g = getattr(engine, "g", None)
    if g is not None:
        return int(g.n)
    return None


def count_traversed_edges(out_deg: np.ndarray, levels: np.ndarray) -> int:
    """Paper §VI-A GTEPS numerator: out-degrees of reached vertices, summed
    over every source row of ``levels`` ([n] or [B, n])."""
    levels = np.atleast_2d(np.asarray(levels))
    reached = levels < INF                            # [B, n]
    return int((reached @ np.asarray(out_deg, dtype=np.int64)).sum())


def bfs_oracle(csr: CSRGraph, root: int) -> np.ndarray:
    """Pure-python BFS (Algorithm 1) — the correctness oracle."""
    from collections import deque
    level = np.full(csr.num_vertices, INF, dtype=np.int64)
    level[root] = 0
    q = deque([root])
    while q:
        v = q.popleft()
        for u in csr.neighbors(v):
            if level[u] == INF:
                level[u] = level[v] + 1
                q.append(int(u))
    return level
