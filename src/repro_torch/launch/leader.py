"""Serve the distributed engine from one process: this process is the
group's first rank (the leader, on the first card) and starts the other
ranks itself, one spawned process a further card, each given only its
own shards through shared memory.

    shards = partition_rank_shards(out_indptr, out_indices, in_indptr,
                                   in_indices, 4 * 2, 4)   # 4 cards, 2 PEs
    group = start_group(shards)
    rows = group.engine.run_batch(roots)         # int32 [B, n]
    ...
    reports = group.close()

Each follower joins the process group, builds ``DistributedBFS`` on its
shards over the ``("data",)`` mesh of every rank, serves the leader's
calls in ``follow()`` until ``close()``, and reports what it did (calls
served, the device it ran on, its card's peak memory, the top-level
packages its process loaded).  NCCL on the cards (``device=None``), gloo
on the CPU (``device="cpu"``); the group meets at ``init_method``, by
default a free TCP port on this host.
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
from repro_torch.core.partition import RankShards
from repro_torch.core.vertex_program import BFS, VertexProgram, get_program
from repro_torch.launch.mesh import make_mesh

# How long a collective may wait for a peer before the group gives up
# (NCCL's watchdog then ends the process instead of hanging it).
GROUP_TIMEOUT_S = 600.0
# How long close() waits for the followers' reports and exits, in all.
CLOSE_TIMEOUT_S = 60.0


def free_port() -> int:
    """A TCP port on localhost that no socket holds right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _backend(device) -> tuple[str, object]:
    if device is None or torch.device(device).type == "cuda":
        return "nccl", None
    return "gloo", "cpu"


def _join(rank: int, world: int, init_method: str, backend: str) -> None:
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _follower(rank: int, world: int, init_method: str, device,
              shards: RankShards, cfg: DistConfig, program: str,
              reports) -> None:
    """A follower process: join, build, follow, report, leave the group.
    The report goes first: NCCL's teardown waits for every rank, and the
    leader tears down only once it holds every report."""
    backend, mesh_dev = _backend(device)
    report = dict(rank=rank, calls=0, device=None, peak_bytes=None,
                  error=None)
    joined = False
    try:
        _join(rank, world, init_method, backend)
        joined = True
        mesh = make_mesh((world,), ("data",), device=mesh_dev)
        eng = DistributedBFS(shards, mesh, cfg=cfg,
                             program=get_program(program))
        del shards
        report["device"] = str(eng.device)
        report["calls"] = eng.follow()
        if eng.device.type == "cuda":
            report["peak_bytes"] = torch.cuda.max_memory_allocated(
                eng.device)
    except BaseException as exc:       # reported, then raised
        report["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        report["modules"] = sorted({m.split(".")[0] for m in sys.modules})
        reports.put(report)
        if joined:
            dist.destroy_process_group()


@dataclasses.dataclass
class Group:
    """The leader's side of a started group: its ``engine`` serves; the
    followers' processes run until :meth:`close`."""

    engine: DistributedBFS
    procs: list
    reports: object

    def close(self, timeout: float = CLOSE_TIMEOUT_S) -> list[dict]:
        """Release the followers, take their reports, destroy the group
        (every rank at once), and return each follower's report (rank
        order); a follower that sent none, or did not exit, within
        ``timeout`` seconds in all is reported with its ``error``."""
        deadline = time.monotonic() + timeout
        try:
            self.engine.close()
        finally:
            got = {}
            for _ in self.procs:
                try:
                    r = self.reports.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    break
                got[r["rank"]] = r
            self.engine = None
            dist.destroy_process_group()
            for p in self.procs:
                p.join(max(deadline - time.monotonic(), 0.1))
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for rank, p in enumerate(self.procs, start=1):
            r = got.get(rank, dict(rank=rank, calls=None, device=None,
                                   peak_bytes=None, error="no report"))
            if p.exitcode and not r.get("error"):
                r["error"] = f"exit code {p.exitcode}"
            out.append(r)
        return out


def start_group(shards: list[RankShards], *, device=None,
                cfg: DistConfig | None = None, program: VertexProgram = BFS,
                init_method: str | None = None) -> Group:
    """Start a group of ``len(shards)`` ranks with this process as rank 0
    (the leader, on the first card or the CPU) and one spawned follower a
    further rank, on card ``rank``.  ``shards[r]`` is rank ``r``'s
    (``partition_rank_shards``); the followers' are moved to shared
    memory and mapped by their processes, never pickled whole.  No
    process group may be started in this process already."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already started here")
    world = len(shards)
    if program.name not in ("bfs", "cc", "sssp"):
        raise ValueError(f"followers run registered programs only, not "
                         f"{program.name!r}")
    cfg = cfg or DistConfig()
    backend, mesh_dev = _backend(device)
    init_method = init_method or f"tcp://localhost:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    reports = ctx.Queue()
    procs = []
    for rank in range(1, world):
        mine = shards[rank].to("cpu").share_memory_()
        p = ctx.Process(target=_follower, args=(
            rank, world, init_method, device, mine, cfg, program.name,
            reports), daemon=True)
        p.start()
        procs.append(p)
        del mine
    try:
        _join(0, world, init_method, backend)
        mesh = make_mesh((world,), ("data",), device=mesh_dev)
        engine = DistributedBFS(shards[0], mesh, cfg=cfg, program=program)
    except BaseException:
        for p in procs:
            p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    return Group(engine, procs, reports)
