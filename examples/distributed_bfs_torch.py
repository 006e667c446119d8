"""Distributed-BFS example on the PyTorch port: the paper's Table II
configurations, scaled to the process group's ranks, with both dispatcher
designs (the counterpart of ``examples/distributed_bfs.py``, with the
same assertions).

Shows the full/multi-layer crossbar trade-off the paper measures
(§IV-D): flat = one all-to-all over all ranks; staged = one exchange per
mesh axis (the k-layer crossbar).

One process a rank, each on its own CUDA card (NCCL), or on the CPU with
``--device cpu`` (gloo ranks); started without torchrun it runs in a
one-rank group of its own.  Every rank makes the same calls; the rows
come back on rank 0 (the engine's leader), which asserts and prints.

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      examples/distributed_bfs_torch.py [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core import bfs_oracle, count_traversed_edges, partition_graph
from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
from repro_torch.core.perf_model import (full_crossbar_fifos,
                                         multilayer_crossbar_fifos)
from repro_torch.device import device_name
from repro_torch.graph import get_dataset
from repro_torch.launch.mesh import make_mesh, mesh_device, process_group

GRAPH = "rmat18-16"
ENGINES = (("bitmap", "flat"), ("bitmap", "staged"), ("queue", "flat"))
BATCH = 32                                 # concurrent MS-BFS queries
UNREACHED = 1 << 30


def run(graph: str = GRAPH, device=None) -> dict:
    """The example on ``graph`` over every rank of the process group (a
    one-rank group of its own when none is started); what ``main()``
    prints."""
    with process_group(device):
        return _run(graph, device)


def _run(graph: str, device) -> dict:
    n_dev = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    ds = get_dataset(graph)
    deg = np.diff(ds.csr.indptr)
    root = int(np.argmax(deg))
    oracle = np.minimum(bfs_oracle(ds.csr, root), UNREACHED)

    # 2 PEs per PC, the paper's 32PC/64PE shape (scaled to n_dev PCs)
    q = n_dev * 2
    pg = partition_graph(ds.csr, ds.csc, q)
    if n_dev >= 4:
        mesh = make_mesh((n_dev // 2, 2), ("data", "model"), device)
    else:
        mesh = make_mesh((n_dev,), ("data",), device)
    where = device_name(mesh_device(mesh))
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"devices={n_dev} mesh={shape} shards={q} (2 PEs/PC)")

    engines = []
    for dispatch, crossbar in ENGINES:
        eng = DistributedBFS(pg, mesh, cfg=DistConfig(
            dispatch=dispatch, crossbar=crossbar))
        lev = eng.run(root)          # warm-up + correctness
        assert lev is None or np.array_equal(np.minimum(lev, UNREACHED),
                                             oracle)
        t0 = time.perf_counter()
        lev = eng.run(root)
        dt = time.perf_counter() - t0
        gteps = None
        if lev is not None:
            assert np.array_equal(np.minimum(lev, UNREACHED), oracle)
            trav = int(deg[np.minimum(lev, UNREACHED) < UNREACHED].sum())
            gteps = trav / dt / 1e9
            say(f"  {dispatch:6s}/{crossbar:6s}: ok, {dt:.2f}s, "
                f"{gteps:.4f} GTEPS ({where}), {counts(eng)}")
        engines.append(dict(dispatch=dispatch, crossbar=crossbar,
                            seconds=dt, gteps=gteps,
                            last_stats=counts(eng)))

    fifos = dict(full_64=full_crossbar_fifos(64),
                 layered_4x4x4=multilayer_crossbar_fifos((4, 4, 4)))
    say("crossbar resource model (paper §IV-D):",
        f"64x64 full = {fifos['full_64']} FIFOs,",
        f"3-layer 4x4 = {fifos['layered_4x4x4']} FIFOs")

    # batched MS-BFS: 32 concurrent queries share every edge read and every
    # crossbar exchange (one bit-plane per source) — the aggregate-GTEPS
    # serving mode.  Also reachable via repro_torch.launch.serve.bfs_batch.
    rng = np.random.default_rng(0)
    roots = rng.choice(np.flatnonzero(deg > 0), BATCH, replace=False)
    eng = DistributedBFS(pg, mesh, cfg=DistConfig(dispatch="bitmap",
                                                  crossbar="flat"))
    levels = eng.run_batch(roots)          # warm-up + correctness
    for i, r in enumerate(roots[:4] if levels is not None else ()):
        # spot-check vs per-root oracle
        assert np.array_equal(np.minimum(levels[i], UNREACHED),
                              np.minimum(bfs_oracle(ds.csr, int(r)),
                                         UNREACHED))
    t0 = time.perf_counter()
    levels = eng.run_batch(roots)
    dt = time.perf_counter() - t0
    gteps = None
    if levels is not None:
        gteps = count_traversed_edges(deg, levels) / dt / 1e9
        say(f"  MS-BFS batch={BATCH}: ok, {dt:.2f}s, {gteps:.4f} "
            f"aggregate GTEPS ({where}), {counts(eng)}")
    return dict(graph=graph, devices=n_dev, mesh=shape, shards=q,
                device=where, engines=engines, fifos=fifos,
                batch=dict(size=BATCH, seconds=dt, gteps=gteps,
                           last_stats=counts(eng)))


def counts(eng) -> dict:
    """The reference's counts of the engine's last call (its
    ``last_stats`` without the port's timings and byte counters)."""
    return {k: v for k, v in eng.last_stats.items()
            if k not in ("seconds", "exchange_bytes", "readback")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default this rank's CUDA card")
    args = ap.parse_args(argv)
    with process_group(args.device):
        out = run(device=args.device)
        if dist.get_rank() == 0:
            print(json.dumps(out))


if __name__ == "__main__":
    main()
