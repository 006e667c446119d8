"""Async BFS serving walkthrough on the PyTorch port: dynamic batching of
single-root queries (the counterpart of ``examples/serve_bfs_async.py``).

A stream of independent ``submit(root)`` calls — the shape real traffic
arrives in — is coalesced by ``repro_torch.launch.dynbatch.DynamicBatcher``
into full MS-BFS waves (up to 32 roots = one uint32 plane word per wave),
so every CSR/CSC edge read serves the whole wave; on the card each wave's
propagate is the whole-array propagate kernel.  Three scenes:

1. Deterministic scheduling with an injected fake clock (how the tests
   drive the scheduler: no threads, ``pump()`` by hand).
2. A real threaded batcher serving a burst of clients.
3. Backpressure: the bounded queue rejecting an overload.

Runs on the CUDA card, or on the CPU with ``--device cpu``:

  PYTHONPATH=src python examples/serve_bfs_async_torch.py [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch.core import (MultiSourceBFSRunner, bfs_oracle,
                              build_local_graph)
from repro_torch.graph import get_dataset
from repro_torch.launch.dynbatch import DynamicBatcher, QueueFull

GRAPH = "small-12-8"
REQUESTS = 48
UNREACHED = 1 << 30


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def run(graph: str = GRAPH, device=None) -> dict:
    """The three scenes on ``graph``; what ``main()`` prints."""
    ds = get_dataset(graph)
    engine = MultiSourceBFSRunner(build_local_graph(ds.csr, ds.csc, device))
    deg = np.diff(ds.csr.indptr)
    rng = np.random.default_rng(0)
    roots = rng.choice(np.flatnonzero(deg > 0), REQUESTS, replace=True)

    # -- 1. deterministic fake-clock mode --------------------------------
    clock = FakeClock()
    batcher = DynamicBatcher(engine, window=0.01, max_batch=32, clock=clock)
    futures = [batcher.submit(int(r), block=False) for r in roots[:5]]
    assert batcher.pump() is None, "window still open -> no wave yet"
    clock.advance(0.02)                      # past the 10 ms window
    wave = batcher.pump()
    print(f"[fake clock] 5 submits -> 1 wave: batch={wave.batch} "
          f"slots={wave.n_slots} iters={wave.iterations} "
          f"teps={wave.aggregate_teps:.0f}")
    ok = all(np.array_equal(f.result(), bfs_oracle(ds.csr, f.root))
             for f in futures)
    print(f"[fake clock] futures match bfs_oracle: {ok}, "
          f"latencies={[f.latency for f in futures]}")
    batcher.close()
    scene1 = dict(batch=wave.batch, n_slots=wave.n_slots,
                  iterations=wave.iterations, teps=wave.aggregate_teps,
                  oracle_match=ok, latencies=[f.latency for f in futures])

    # -- 2. threaded serving (real clock) --------------------------------
    with DynamicBatcher(engine, out_deg=deg, window=0.05) as batcher:
        futures = [batcher.submit(int(r)) for r in roots]
        levels = [f.result(timeout=60.0) for f in futures]
    s = batcher.stats()
    print(f"[threaded] {s['requests']} requests -> {s['waves']} waves "
          f"(mean batch {s['mean_batch']}), p50={s['latency_p50']}s "
          f"p99={s['latency_p99']}s aggregate_teps={s['aggregate_teps']}")
    reached = float(np.mean([(lv < UNREACHED).sum() for lv in levels]))
    ok2 = all(np.array_equal(lv, bfs_oracle(ds.csr, int(r)))
              for lv, r in zip(levels, roots))
    print(f"[threaded] mean vertices reached per query: {reached:.0f}, "
          f"levels match bfs_oracle: {ok2}")
    scene2 = dict(stats=s, mean_reached=reached, oracle_match=ok2)

    # -- 3. backpressure -------------------------------------------------
    batcher = DynamicBatcher(engine, window=1.0, max_pending=4,
                             clock=FakeClock())
    for r in roots[:4]:
        batcher.submit(int(r), block=False)
    rejected = None
    try:
        batcher.submit(int(roots[4]), block=False)
    except QueueFull as e:
        rejected = str(e)
        print(f"[backpressure] 5th submit rejected: {e}")
    batcher.close(drain=True)                # serves the 4 queued requests
    drained = batcher.stats()["waves"]
    print(f"[backpressure] drained waves: {drained}")
    return dict(graph=graph, scene1=scene1, scene2=scene2,
                scene3=dict(rejected=rejected, drained_waves=drained))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device)))


if __name__ == "__main__":
    main()
