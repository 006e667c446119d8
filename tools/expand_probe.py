#!/usr/bin/env python3
"""Time the frontier expansion (``kernels.expand_frontier``) at the levels
of a wave on the benchmark's graphs.

For each graph (``bfsbench/configs/<name>.json``, built by the benchmark's
generator from ``SEED``), one wave of 64 keys runs through
``MultiSourceBFSRunner`` while every ``expand_frontier`` call is captured
(mask, direction, budget).  Then, at the largest pull level and at the
last (tail) level: the kernels as called (``expand_frontier``), the vertex
scan and the slot pass alone (``launch`` with phases 1 and 2), the plain
version (``compact_indices`` + ``expand_edges`` on the card), and the bound
(``expand_traffic`` bytes at 3.35 TB/s).  CUDA events over ``REPS`` calls
after a warm-up.

    PYTHONPATH=src:. python3 tools/expand_probe.py [kron22-16 kron22-64]

Needs a CUDA card; prints one JSON line a graph and a timed level.
"""
import json
import subprocess
import sys
import time

sys.path[:0] = ["src", "."]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bfsbench import harness  # noqa: E402
from repro_torch.core import MultiSourceBFSRunner  # noqa: E402
from repro_torch.kernels import expand_frontier as kef  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SEED = 3232323232
REPS = 10
HBM = 3.35e12


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def timed(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(graphs):
    dev = torch.device("cuda", 0)
    print(json.dumps(dict(card=card(), torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)
    for name in graphs:
        t0 = time.perf_counter()
        cfg = json.loads(open(f"bfsbench/configs/{name}.json").read())
        host, host_t, _ = harness.build_graph(cfg, SEED, dev)
        g = harness.program_graph(cfg, host, host_t, dev)
        deg = np.diff(host[0])
        roots = np.random.default_rng(SEED).choice(np.flatnonzero(deg > 0),
                                                   64, replace=False)
        levels = []
        orig = kef.expand_frontier

        def spy(mask, indptr, indices, budget):
            levels.append((mask.clone(), indptr is g.in_indptr, budget))
            return orig(mask, indptr, indices, budget)

        runner = MultiSourceBFSRunner(g)
        runner.run(roots)                                   # warm
        kef.expand_frontier = spy
        try:
            res = runner.run(roots)
        finally:
            kef.expand_frontier = orig
        print(json.dumps(dict(graph=name, setup_s=round(
            time.perf_counter() - t0, 2), iterations=res.iterations,
            seconds=res.seconds, budget_slots=runner.last_stats[
                "budget_slots"], edges_inspected=res.edges_inspected,
            budgets=[b for _, _, b in levels],
            pulls=[p for _, p, _ in levels])), flush=True)
        del runner, res
        torch.cuda.empty_cache()
        totals = []
        for mask, pull, budget in levels:
            indptr = g.in_indptr if pull else g.out_indptr
            d = (indptr[1:] - indptr[:-1])
            totals.append(int(d[mask].sum()))
        pull_lv = [i for i, (_, p, _) in enumerate(levels) if p]
        picks = {"largest_pull": max(pull_lv, key=lambda i: totals[i]),
                 "tail": len(levels) - 1}
        for label, i in picks.items():
            mask, pull, budget = levels[i]
            indptr, indices = ((g.in_indptr, g.in_indices) if pull
                               else (g.out_indptr, g.out_indices))
            nbytes = kef.expand_traffic(mask, indptr, budget)
            bufs = kef.buffers(mask, budget)
            ms_called = timed(lambda: kef.expand_frontier(mask, indptr,
                                                          indices, budget))
            ms_a = timed(lambda: kef.launch(mask, indptr, indices, budget,
                                            bufs, 1))
            ms_b = timed(lambda: kef.launch(mask, indptr, indices, budget,
                                            bufs, 2))
            got = kef.expand_frontier(mask, indptr, indices, budget)
            torch.cuda.synchronize()
            ms_plain = timed(lambda: ref.expand_frontier_ref(
                mask, indptr, indices, budget), 3)
            want = ref.expand_frontier_ref(mask, indptr, indices, budget)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            del got, want, bufs
            torch.cuda.empty_cache()
            bound = nbytes / HBM * 1e3
            print(json.dumps(dict(
                graph=name, level=label, index=i, pull=pull, budget=budget,
                total=totals[i], active=int(mask.sum()), bytes=nbytes,
                bound_ms=round(bound, 5), called_ms=round(ms_called, 5),
                scan_ms=round(ms_a, 5), slots_ms=round(ms_b, 5),
                plain_ms=round(ms_plain, 4),
                share_called=round(bound / ms_called, 4),
                share_alone=round(bound / (ms_a + ms_b), 4),
                bit_equal=same)), flush=True)
        del g, levels
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:] or ["kron22-16", "kron22-64"])
