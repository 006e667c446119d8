"""The control of ``correct``: the plain reference put in the program's
place with the configuration's exactness guarantee broken (every level's
expansion cut at a sixteenth of the arcs, no retry; see
``refbfs.control_cap``).  The benchmark's own runs never run it.

    python3 -m bfsbench.control --workload kron22-16.wave64 \
        --seconds 8 --seeds 11 12 13

prints one JSON line a seed with the compared numbers of the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bfsbench import refbfs


class ControlEngine:
    """The control with the program's entries: a closed-loop call
    ``(roots) -> (rows, None)`` and the engine protocol
    (``num_vertices``, ``out_deg``, ``run_batch``, ``last_stats``) the
    batcher drives."""

    def __init__(self, host, device: torch.device):
        self.indptr = torch.from_numpy(host[0]).to(device)
        self.indices = torch.from_numpy(host[1]).to(device)
        self.cap = refbfs.control_cap(int(self.indices.numel()))
        self.num_vertices = int(self.indptr.numel()) - 1
        self.out_deg = np.diff(host[0]).astype(np.int64)
        self.last_stats: dict = {}

    @classmethod
    def make(cls, host, device, mix) -> "ControlEngine":
        return cls(host, device)

    def run_batch(self, roots, **_kw) -> np.ndarray:
        return np.stack([
            refbfs.bfs_levels(self.indptr, self.indices, int(r),
                              truncate=self.cap).cpu().numpy()
            for r in np.asarray(roots)])

    def __call__(self, roots):
        return self.run_batch(roots), None


def main(argv=None) -> int:
    from bfsbench.run import program_path
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    program_path()
    from bfsbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               dev, time.perf_counter(),
                               make_entry=ControlEngine.make)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
