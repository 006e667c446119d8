"""Find the served mix's knee: the highest open-loop rate whose backlog does
not grow over the window.  Run once on the card; its answer, times 4/5,
is written into the mix file as a number (the benchmark never searches
for a rate).

    python3 -m bfsbench.sweep --workload kron22-16.served --seed 5 \
        --seconds 20 --rates 60 80 100 120

prints one JSON line a rate: requests, the median latency of each
quarter of the arrivals, the waves by padded size, and whether the backlog grew: the last
quarter's median latency more than a tenth above the second's (the first
quarter holds the stream's start, when no wave is queued yet).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def backlog_grew(quarters: list[float]) -> bool:
    return quarters[3] > 1.1 * quarters[1]


def main(argv=None) -> int:
    from bfsbench.run import program_path
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    program_path()
    from bfsbench import drive, harness
    from bfsbench.trace import Tracer
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    cfg = harness.read_config(cell["config"])
    mix = harness.read_mix(cell["traffic"])
    host, host_t, _ = harness.build_graph(cfg, args.seed, dev)
    g = harness.program_graph(cfg, host, host_t, dev)
    keys = np.flatnonzero(np.diff(host[0]) > 0)
    rng = np.random.default_rng(args.seed)
    tracer = Tracer(False, dev)
    warm = True
    for rate in args.rates:
        loop = drive.make_loop(g, dict(mix, rate=rate), keys, rng, tracer)
        if warm:
            loop.warm()
            warm = False
        reqs = loop.window(args.seconds,
                           drive.Reservoir(0, np.random.default_rng(0)))
        stats = loop.stats()
        slots = [w.n_slots for w in loop.batcher.waves]
        loop.close()
        ok = [r for r in reqs if r.ok]
        lat = np.asarray([r.done - r.due for r in ok])
        quarters = [float(np.median(part))
                    for part in np.array_split(lat, 4)]
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "served": len(ok),
            "latency_quarters_s": quarters,
            "latency_p95_s": float(np.percentile(lat, 95)),
            "mean_batch": stats["mean_batch"], "waves": stats["waves"],
            "wave_slots": {str(k): slots.count(k) for k in sorted(set(slots))},
            "backlog_grew": backlog_grew(quarters)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
