"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``, with the same assertions).

1. Generate a Graph500 Kronecker graph (the paper's RMAT suite).
2. Run hybrid-mode BFS with the local engine and verify against the
   pure-python oracle (on the card, each level's P3 is the bitmap-update
   kernel).
3. Partition the graph the paper's way (VID % Q) and run the distributed
   engine over a mesh of the process group's ranks.
4. Evaluate the paper's §V performance model for this graph, for the
   U280 and for the H100's HBM (the port has no TPU model).

Runs on the CUDA card, or on the CPU with ``--device cpu``; it starts a
one-rank process group itself (NCCL on the card, gloo on the CPU), or
runs in the group that torchrun starts:

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import json

import numpy as np
import torch.distributed as dist

from repro_torch.core import (BFSRunner, SchedulerConfig, bfs_oracle,
                              build_local_graph, partition_graph)
from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
from repro_torch.core.perf_model import h100_model_teps, perf_total
from repro_torch.device import device_name
from repro_torch.graph import get_dataset
from repro_torch.launch.mesh import make_mesh, mesh_device, process_group

GRAPH = "rmat18-8"
SHARDS = 4                                 # 4 PEs over the mesh's ranks
UNREACHED = 1 << 30


def same_levels(got, want) -> bool:
    return np.array_equal(np.minimum(got, UNREACHED),
                          np.minimum(want, UNREACHED))


def run(graph: str = GRAPH, device=None) -> dict:
    """The quickstart's four steps on ``graph`` over every rank of the
    process group (a one-rank group of its own when none is started);
    what ``main()`` prints.  Rank 0 prints the lines; every rank
    asserts."""
    with process_group(device):
        return _run(graph, device)


def _run(graph: str, device) -> dict:
    world = dist.get_world_size()
    mesh = make_mesh((world,), ("data",), device)
    dev = mesh_device(mesh)
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    where = device_name(dev)

    # -- 1. graph ---------------------------------------------------------
    ds = get_dataset(graph)
    n, m = ds.csr.num_vertices, ds.csr.indices.size
    deg = np.diff(ds.csr.indptr)
    root = int(np.argmax(deg))
    say(f"graph {graph}: |V|={n:,} |E|={m:,} root={root}")

    # -- 2. local hybrid BFS vs oracle -------------------------------------
    g = build_local_graph(ds.csr, ds.csc, device=dev)
    res = BFSRunner(g, SchedulerConfig(policy="beamer")).run(root)
    oracle = bfs_oracle(ds.csr, root)
    assert same_levels(res.level, oracle)
    say(f"local hybrid BFS: {res.iterations} iters "
        f"({res.push_iters} push / {res.pull_iters} pull), "
        f"{res.gteps:.4f} GTEPS ({where}), levels match oracle")

    # -- 3. distributed engine (paper §IV) ---------------------------------
    pg = partition_graph(ds.csr, ds.csc, SHARDS)
    eng = DistributedBFS(pg, mesh, cfg=DistConfig(dispatch="bitmap",
                                                  crossbar="flat"))
    lev = eng.run(root)
    assert same_levels(lev, oracle)
    # the reference's counts (the port adds its timings and byte counters)
    counts = {k: v for k, v in eng.last_stats.items()
              if k not in ("seconds", "exchange_bytes", "readback")}
    say(f"distributed BFS (Q={SHARDS} shards, {world} rank(s)): levels "
        f"match oracle, stats={counts}")

    # -- 4. the paper's §V model and its H100 re-parameterization ---------
    len_nl = float(deg[deg > 0].mean())
    u280 = perf_total(2, 32, len_nl) / 1e9
    h100 = h100_model_teps(1, len_nl) / 1e9
    say(f"§V model, Len_nl={len_nl:.1f}: U280 32PC/64PE -> {u280:.2f} "
        f"GTEPS (paper measures 19.7 peak); one H100 at its HBM rate -> "
        f"{h100:.0f} GTEPS (the port has no TPU model)")
    return dict(graph=graph, vertices=n, edges=m, root=root, device=where,
                local=dict(iterations=res.iterations,
                           push_iters=res.push_iters,
                           pull_iters=res.pull_iters, seconds=res.seconds,
                           gteps=res.gteps),
                distributed=dict(shards=SHARDS, ranks=world,
                                 last_stats=counts),
                model=dict(len_nl=len_nl, u280_gteps=u280,
                           h100_gteps=h100))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default the CUDA card")
    args = ap.parse_args(argv)
    with process_group(args.device):
        out = run(device=args.device)
        if dist.get_rank() == 0:
            print(json.dumps(out))


if __name__ == "__main__":
    main()
