"""Production-scale dry-run of the distributed BFS step programs: the BFS
half of ``repro.launch.dryrun``.

The reference lowers and compiles the engine's push and pull step
programs at Q = 256 and 512 graph shards on forced host devices.  Eager
PyTorch has nothing to lower, so the port *runs* them: one process is rank
0 of the production mesh (``launch.mesh.make_production_mesh``: 16x16, or
2x16x16 with ``--multi-pod``) over a fake process group, whose
collectives run without peers, and drives one push and one pull step of
``DistributedBFS.abstract`` on zero-filled stand-ins of its shards.  A
step that runs proves that the shard arithmetic, the crossbar's groups
and the step's buffers fit one rank at that scale.  The record gives the
cell's shard arithmetic and ``setup_s``, the seconds to build the mesh,
the engine and its inputs; each phase records:

  * ``step_s``: the wall seconds of one uncounted step (synchronised on
    the card);
  * ``per_device``: ``launch.step_analysis`` of one counted step (FLOPs,
    HBM bytes, collective bytes by kind, loop-aware), and ``roofline``:
    ``launch.roofline.roofline_terms`` of it on the H100;
  * ``memory``: the step's argument and output bytes and, on the card,
    its peak bytes (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``); null on the CPU.

XLA's ``cost_analysis`` (its own FLOPs and bytes) has no counterpart and
is not recorded.  The reference's LM cells (``lower_lm_cell``) wait for
the port of the LM stack.  Usage:

  python -m repro_torch.launch.dryrun --bfs rmat22-16 [--multi-pod] \\
      [--dispatch bitmap|queue] [--crossbar staged|flat] [--device cpu]
  python -m repro_torch.launch.dryrun --all [--jobs 4]   # every cell

``--all`` runs each cell in its own subprocess, as the reference does (a
process holds one default process group), ``--jobs`` of them at a time
(default 1: one after another, as the reference); a cell whose JSON is
already under ``--out`` is skipped.  ``--device`` defaults to the CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed

DEFAULT_OUT = "dryrun_out"


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_bfs_cell(graph_name: str, multi_pod: bool, dispatch: str,
                   crossbar: str, device=None) -> dict:
    """Run and count one push and one pull step of the engine at the
    production shard count for ``graph_name``'s size (``graph.datasets``;
    undirected inputs double the directed edge count, as the reference
    counts them).  Returns the cell's record."""
    import torch

    from repro_torch.core.bfs_distributed import DistConfig, DistributedBFS
    from repro_torch.graph.datasets import DATASETS
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.step_analysis import StepAnalysis

    t0 = time.perf_counter()
    meta = DATASETS[graph_name]
    n = 1 << meta.scale
    avg_deg = meta.edge_factor * (1 if meta.directed else 2)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    eng = DistributedBFS.abstract(mesh, n, cfg=DistConfig(
        dispatch=dispatch, crossbar=crossbar))
    sds = eng.abstract_inputs(avg_degree=avg_deg)
    budget = sds["indices"].shape[1]
    on_card = eng.device.type == "cuda"
    rec: dict = {
        "arch": f"scalabfs-{dispatch}-{crossbar}", "shape": graph_name,
        "mesh": _mesh_tag(multi_pod), "kind": "bfs",
        "num_vertices": n, "verts_per_shard": eng.vl, "shards": eng.q,
        "edge_budget": budget, "n_devices": eng.d,
        "device": (torch.cuda.get_device_name(eng.device) if on_card
                   else "cpu"),
        "setup_s": time.perf_counter() - t0,
    }
    args = (sds["frontier"], sds["visited"], sds["level"], sds["lvl"],
            budget)
    arg_bytes = sum(t.numel() * t.element_size() for t in
                    (*args[:3], sds["indptr"], sds["indices"]))
    for phase, step in (("push", eng._push), ("pull", eng._pull)):
        with StepAnalysis() as a:
            step(*args)
        if on_card:
            torch.cuda.synchronize(eng.device)
            torch.cuda.reset_peak_memory_stats(eng.device)
        t0 = time.perf_counter()
        out = step(*args)
        if on_card:
            torch.cuda.synchronize(eng.device)
        step_s = time.perf_counter() - t0
        per_dev = a.result()
        rec[phase] = {
            "step_s": step_s,
            "per_device": per_dev,
            "roofline": roofline.roofline_terms(per_dev),
            "memory": {
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": sum(
                    t.numel() * t.element_size() for t in out
                    if isinstance(t, torch.Tensor)),
                "peak_bytes": (torch.cuda.max_memory_allocated(eng.device)
                               if on_card else None),
            },
        }
    return rec


# ---------------------------------------------------------------------------
# Fan-out driver (resumable; one subprocess per cell)
# ---------------------------------------------------------------------------

BFS_CELLS = [
    # (graph, dispatch, crossbar) - default engine on both meshes, plus the
    # dispatcher design space on the single pod for §Perf.
    ("rmat22-16", "bitmap", "staged"),
    ("rmat22-16", "bitmap", "flat"),
    ("rmat22-16", "queue", "staged"),
    ("rmat23-64", "bitmap", "staged"),
    ("lj-like", "bitmap", "staged"),
]


def all_cells(out_dir: str) -> list:
    """(record path, CLI arguments) of every BFS cell: the five on the
    single pod, the default engine's three on two pods."""
    cells = []
    for multi_pod in (False, True):
        tag = _mesh_tag(multi_pod)
        for graph, dispatch, crossbar in BFS_CELLS:
            if multi_pod and (dispatch, crossbar) != ("bitmap", "staged"):
                continue  # design-space sweep is single-pod only
            name = f"bfs-{graph}-{dispatch}-{crossbar}"
            path = os.path.join(out_dir, f"{name}__{tag}.json")
            args = ["--bfs", graph, "--dispatch", dispatch,
                    "--crossbar", crossbar]
            cells.append((path, args + (["--multi-pod"] if multi_pod
                                        else [])))
    return cells


def _run_cell(path: str, args: list, device, timeout: float) -> str:
    """One cell in its own subprocess; returns its status line's tail,
    "ok (Ns) name" or a failure with the cell's last output."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
           "--json-out", path]
    if device is not None:
        cmd += ["--device", device]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"TIMEOUT {os.path.basename(path)}"
    dt = time.time() - t0
    if p.returncode != 0:
        tail = (p.stderr or p.stdout).strip().splitlines()[-12:]
        return (f"FAIL ({dt:.0f}s) {os.path.basename(path)}\n  "
                + "\n  ".join(tail))
    return f"ok ({dt:.0f}s) {os.path.basename(path)}"


def run_all(out_dir: str, device: str | None = None,
            timeout: float = 3000.0, jobs: int = 1) -> int:
    """Run every cell not yet recorded under ``out_dir``, each in its own
    subprocess on ``device``, ``jobs`` of them at a time; returns the
    number that failed.  A process's peak memory is its own, so cells
    that share the card still record their own peaks."""
    os.makedirs(out_dir, exist_ok=True)
    cells = all_cells(out_dir)
    todo = []
    for i, (path, args) in enumerate(cells):
        if os.path.exists(path):
            print(f"[{i+1}/{len(cells)}] SKIP (done) {os.path.basename(path)}",
                  flush=True)
        else:
            todo.append((i, path, args))
    failures = 0
    with ThreadPoolExecutor(max(1, jobs)) as pool:
        futures = {pool.submit(_run_cell, path, args, device, timeout): i
                   for i, path, args in todo}
        for f in as_completed(futures):
            line = f.result()
            failures += not line.startswith("ok ")
            print(f"[{futures[f]+1}/{len(cells)}] {line}", flush=True)
    print(f"done: {len(cells)} cells, {failures} failures", flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bfs", metavar="GRAPH")
    ap.add_argument("--dispatch", default="bitmap",
                    choices=["bitmap", "queue"])
    ap.add_argument("--crossbar", default="staged",
                    choices=["staged", "flat"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--json-out")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at a time (default 1)")
    args = ap.parse_args(argv)

    if args.all:
        return 1 if run_all(args.out, args.device, jobs=args.jobs) else 0
    if not args.bfs:
        ap.error("--bfs GRAPH or --all is required")
    try:
        rec = lower_bfs_cell(args.bfs, args.multi_pod, args.dispatch,
                             args.crossbar, device=args.device)
    except Exception:
        traceback.print_exc()
        return 1

    print(json.dumps(rec, indent=2, default=str))
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
