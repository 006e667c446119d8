"""Batched BFS serving on one GPU (port of the BFS half of
``repro.launch.serve``).

Answer a batch of BFS queries over a device-resident graph with one
multi-source traversal (``bfs_batch``) — the serving analogue of the
paper's "keep every memory channel busy" aggregate-TEPS metric:

  PYTHONPATH=src python -m repro_torch.launch.serve --bfs-graph rmat20-16 \
      --bfs-batch 64 [--device cpu]

prints one JSON line.  The dynamic batcher, CC/SSSP serving and the
distributed engine are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.bfs_local import (INF, build_local_graph,
                                        count_traversed_edges)
from repro_torch.core.vertex_program import MultiSourceBFSRunner
from repro_torch.graph import get_dataset


def build_engine(graph: str, *, algo: str = "bfs", device=None,
                 tile_rows: int | None = None):
    """Build a BFS query engine with the graph resident on ``device``
    (None = the CUDA card).  Returns (engine, out_degrees).  Build once,
    reuse across ``bfs_batch`` calls."""
    if algo != "bfs":
        raise NotImplementedError(f"algo {algo!r} is not ported yet (bfs)")
    ds = get_dataset(graph)
    g = build_local_graph(ds.csr, ds.csc, device=device)
    engine = MultiSourceBFSRunner(g, tile_rows=tile_rows)
    return engine, np.diff(ds.csr.indptr)


def bfs_batch(roots, *, graph: str = "rmat16-16", engine=None, out_deg=None,
              algo: str = "bfs", device=None) -> dict:
    """Serve a batch of BFS queries in one batched traversal.

    Duplicate roots are allowed; negative or >= |V| roots raise
    ``ValueError``.  Pass a prebuilt ``engine`` (from :func:`build_engine`)
    to keep the graph resident across calls; otherwise one is built for
    ``graph`` on ``device``.  Returns value rows [B, |V|] plus aggregate
    serving stats."""
    if engine is None:
        engine, out_deg = build_engine(graph, algo=algo, device=device)
    roots = np.asarray(roots)        # the engine validates (no cast here)
    t0 = time.perf_counter()
    levels = engine.run_batch(roots)
    seconds = time.perf_counter() - t0      # traversal only, not stats
    stats = dict(getattr(engine, "last_stats", {}))
    traversed = stats.pop("traversed_edges", None)
    if out_deg is not None:
        traversed = count_traversed_edges(out_deg, levels)
    stats.pop("seconds", None)
    stats["batch"] = int(roots.size)
    out = dict(levels=levels, seconds=round(seconds, 4), **stats)
    if traversed is not None:
        out["traversed_edges"] = traversed
        out["aggregate_teps"] = round(traversed / max(seconds, 1e-12), 1)
    return out


def serve_bfs(graph: str, batch: int, seed: int = 0, algo: str = "bfs", *,
              device=None, tile_rows: int | None = None,
              keep_levels: bool = False) -> dict:
    """Build the engine, then serve one warm-up wave and one timed wave of
    ``batch`` distinct non-isolated roots drawn from ``seed``.  Returns the
    timed wave's stats; ``keep_levels=True`` also returns its ``roots``
    and ``levels`` (for validation)."""
    engine, deg = build_engine(graph, algo=algo, device=device,
                               tile_rows=tile_rows)
    rng = np.random.default_rng(seed)
    roots = rng.choice(np.flatnonzero(deg > 0), batch, replace=False)
    bfs_batch(roots, engine=engine, out_deg=deg)        # warm-up
    out = bfs_batch(roots, engine=engine, out_deg=deg)
    levels = out.pop("levels")
    out.update(graph=graph, algo=algo,
               reached_mean=float((levels < INF).sum(1).mean()))
    if keep_levels:
        out.update(roots=roots, levels=levels,
                   level_seconds=list(engine.last_level_seconds))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bfs-graph", required=True,
                    help="serve batched BFS queries over this graph")
    ap.add_argument("--bfs-batch", type=int, default=32,
                    help="number of concurrent BFS queries")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve_bfs(args.bfs_graph, args.bfs_batch, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
