"""dist_batch: waves of ``batch`` distinct roots, back to back, through
the distributed engine (``DistributedBFS``) sharded over ``runner["ranks"]``
cards, ``pes_per_rank`` PEs a card, hash partitioned, with the runner's
``dispatch`` and ``crossbar``: the value rows [B, n] on the host and the
program's time to its last level (``last_stats["seconds"]``).

This process is the group's first rank (the leader) on the graph's card:
the loop partitions the CSR/CSC of the ``LocalGraph`` it is handed, keeps
no reference to that graph, and starts the other ranks, one process a
further card, through ``repro_torch.launch.leader.start_group``.  ``warm``
runs two waves while it holds the first answer, so that the readback's
two page-locked blocks are made in set-up; ``close`` ends the followers
and the group, and fails the run if a follower failed or loaded JAX, or
if two ranks shared a card.  The result line's ``device.count`` is then
the number of devices the ranks ran on (the harness itself writes 1).

A traced window also records, on the benchmark's ``Probe``, each call's
``last_stats`` (``dist_calls``) and K2's bytes on each call's inputs
(``k2_bytes``, by a hook on ``msbfs_propagate_planes_tiled``).  The hook
never stops the leader: the count is queued on the leader's stream
behind the call, the host never waits for it, and the counts are read
back after the window.  A hook that synchronised would pause the leader
alone while the followers ran ahead into their collectives.
"""
from __future__ import annotations

import inspect
import sys

import torch

from bfsbench import drive, yardstick_dist

# Packages no rank's process may hold: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class Entry:
    def __init__(self, g, kw: dict):
        from repro_torch.core.bfs_distributed import DistConfig
        from repro_torch.core.partition import partition_rank_shards
        from repro_torch.launch.leader import start_group
        ranks, pes = int(kw.get("ranks", 4)), int(kw.get("pes_per_rank", 2))
        n = g.n
        shards = partition_rank_shards(
            g.out_indptr[:n + 1], g.out_indices, g.in_indptr[:n + 1],
            g.in_indices, ranks * pes, ranks)
        cfg = DistConfig(dispatch=kw.get("dispatch", "bitmap"),
                         crossbar=kw.get("crossbar", "staged"))
        dev = g.device
        del g
        self.group = start_group(
            shards, device=None if dev.type == "cuda" else "cpu", cfg=cfg)
        self.engine = self.group.engine
        self.devices = [str(self.engine.device)]
        self.calls: list = []
        self.reports: list = []

    def __call__(self, roots):
        rows = self.engine.run_batch(roots)
        stats = self.engine.last_stats
        self.calls.append(stats)
        return rows, stats.get("seconds")

    def close(self) -> None:
        self.engine = None
        self.reports = self.group.close()
        for r in self.reports:
            print(f"follower {r['rank']}: calls {r['calls']} peak_bytes "
                  f"{r['peak_bytes']} error {r['error']}", file=sys.stderr)
        bad = [r for r in self.reports if r["error"]
               or FORBIDDEN & set(r.get("modules", ()))]
        if bad:
            raise RuntimeError(f"followers failed: {bad}")
        self.devices += [r["device"] for r in self.reports]
        cards = [d for d in self.devices if d.startswith("cuda")]
        if len(set(cards)) < len(cards):
            raise RuntimeError(f"ranks shared cards: {self.devices}")


class DistLoop(drive.ClosedLoop):
    """``ClosedLoop`` with the two-wave warm-up, the traced window's
    records and the group's end."""

    def warm(self) -> None:
        held = self.entry(self._roots())
        self.entry(self._roots())
        del held

    def window(self, seconds: float, sample: drive.Reservoir) -> list:
        probe = self.counter
        if probe is None:
            return super().window(seconds, sample)
        queued: list = []
        undo = _hook_k2(queued)
        calls = getattr(self.entry, "calls", None)
        first = len(calls) if calls is not None else 0
        try:
            return super().window(seconds, sample)
        finally:
            for owner, name, orig in reversed(undo):
                setattr(owner, name, orig)
            probe.k2_bytes = [int(b) for b in queued]
            if calls is not None:
                probe.dist_calls = calls[first:]

    def close(self) -> None:
        end = getattr(self.entry, "close", None)
        if end is not None:
            end()
        devices = getattr(self.entry, "devices", None)
        if devices:
            _count_devices(len(set(devices)))
        super().close()


def _count_devices(count: int) -> None:
    """Have the harness's next result line report ``count`` devices: its
    ``result`` writes one, the leader's card, whatever the loop ran on."""
    from bfsbench import harness
    base = harness.result

    def result(*args, **kw):
        harness.result = base
        out = base(*args, **kw)
        out["device"]["count"] = count
        return out

    harness.result = result


def _hook_k2(queued: list) -> list:
    """Queue K2's bytes on each call's inputs, as a tensor on the call's
    device, onto ``queued``, wherever a module of the program holds the
    kernel's entry; returns what to put back."""
    from repro_torch.kernels import msbfs_propagate
    orig = getattr(msbfs_propagate, "msbfs_propagate_planes_tiled", None)
    if orig is None:
        return []
    sig = inspect.signature(orig)

    def hook(*args, **kw):
        out = orig(*args, **kw)
        try:
            a = sig.bind(*args, **kw).arguments
            inputs = (a["seen"], a["msg"], a["tile_chunks"],
                      a["block_edges"])
        except (TypeError, KeyError):
            return out
        queued.append(yardstick_dist.k2_bytes(*inputs))
        return out

    undo = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != "repro_torch":
            continue
        for attr, value in list(vars(mod).items()):
            if value is orig:
                setattr(mod, attr, hook)
                undo.append((mod, attr, orig))
    return undo


def make(g, mix, keys, rng, tracer, entry=None):
    if entry is None:
        entry = Entry(g, mix.get("runner", {}))
    return DistLoop(entry, int(mix.get("batch", 1)), keys, rng, tracer)
