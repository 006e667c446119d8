"""Batched graph-query serving on one GPU (port of the graph half of
``repro.launch.serve``).

Answer a batch of queries over a device-resident graph with one
multi-source traversal (``bfs_batch``) — the serving analogue of the
paper's "keep every memory channel busy" aggregate-TEPS metric.  The
vertex program is BFS, connected components (``--algo cc``, over the
symmetrized graph) or unit-weight SSSP (``--algo sssp``):

  PYTHONPATH=src python -m repro_torch.launch.serve --bfs-graph rmat20-16 \
      --bfs-batch 64 [--algo bfs|cc|sssp] [--bfs-sparse-pull] [--device cpu]

prints one JSON line.  The dynamic batcher, the worker pool, the fault
tolerance layer and the distributed engine are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.bfs_local import (INF, build_local_graph,
                                        count_traversed_edges)
from repro_torch.core.vertex_program import (ConnectedComponentsRunner,
                                             MultiSourceBFSRunner,
                                             SSSPRunner, get_program)
from repro_torch.graph import get_dataset, symmetrize_csr

RUNNERS = {"bfs": MultiSourceBFSRunner, "cc": ConnectedComponentsRunner,
           "sssp": SSSPRunner}


def build_engine(graph: str, *, algo: str = "bfs", device=None,
                 tile_rows: int | None = None, sparse_pull: bool = False):
    """Build a vertex-program query engine with the graph resident on
    ``device`` (None = the CUDA card).

    ``algo``: "bfs" | "cc" | "sssp"; an unknown name raises ValueError.
    CC symmetrizes the graph first (components are an undirected notion).
    ``sparse_pull=True`` takes the budgeted pull on tail levels of the
    plain path.  Returns (engine, out_degrees of the graph traversed).
    Build once, reuse across ``bfs_batch`` calls."""
    program = get_program(algo)
    ds = get_dataset(graph)
    csr, csc = ds.csr, ds.csc
    if program.undirected:
        csr = symmetrize_csr(csr)
        csc = csr            # a symmetrized graph is its own transpose
    g = build_local_graph(csr, csc, device=device)
    engine = RUNNERS[algo](g, tile_rows=tile_rows, sparse_pull=sparse_pull)
    return engine, np.diff(csr.indptr)


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
              sparse_pull: bool = False, keep_levels: bool = False) -> dict:
    """Build the engine, then serve one warm-up wave and one timed wave of
    ``batch`` distinct non-isolated roots drawn from ``seed``.  Returns the
    timed wave's stats; ``keep_levels=True`` also returns its ``roots``
    and ``levels`` (for validation)."""
    engine, deg = build_engine(graph, algo=algo, device=device,
                               tile_rows=tile_rows, sparse_pull=sparse_pull)
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
    ap.add_argument("--algo", choices=tuple(RUNNERS), default="bfs",
                    help="vertex program to serve")
    ap.add_argument("--bfs-sparse-pull", action="store_true",
                    help="budgeted sparse pull on tail levels (reads "
                         "only unvisited vertices' in-lists)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = serve_bfs(args.bfs_graph, args.bfs_batch, algo=args.algo,
                    device=args.device, sparse_pull=args.bfs_sparse_pull)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
