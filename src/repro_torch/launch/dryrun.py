"""Production-scale dry-run of the step programs: the port of
``repro.launch.dryrun``, LM cells and BFS cells.

The reference lowers and compiles each step at the production meshes'
shard counts on forced host devices.  Eager PyTorch has nothing to lower,
so the port *runs* them: one process is rank 0 of the production mesh
(``launch.mesh.make_production_mesh``: 16x16, or 2x16x16 with
``--multi-pod``) over a fake process group, whose collectives run
without peers, and drives one step at that rank's shapes.  A step that
runs proves that the shardings, the collectives' groups and the step's
buffers fit one rank at that scale.

* **LM cells** (:func:`lower_lm_cell`, ``--arch A --shape S``): the
  train, prefill or serve step of ``train.step`` on the cell's inputs
  (``launch.shapes.input_specs``), the state, batch and caches DTensors
  placed by ``launch.shardings`` (the reference's specs).  On the card
  each rank-0 block is a real zero-filled CUDA tensor; with ``--device
  cpu`` every block is ``meta`` and nothing is allocated (the
  reference's ``ShapeDtypeStruct``), the step runs on shapes alone, and
  ``step_s`` and ``peak_bytes`` are null (``"device": "meta"``).
* **BFS cells** (:func:`lower_bfs_cell`, ``--bfs G``): one push and one
  pull step of ``DistributedBFS.abstract`` on zero-filled stand-ins of
  its shards, with the cell's shard arithmetic.

Each step's record gives ``setup_s`` (the seconds to build the mesh, the
model or engine and its inputs) and:

  * ``step_s``: the wall seconds of one uncounted step (synchronised on
    the card);
  * ``per_device``: ``launch.step_analysis`` of one counted step (FLOPs,
    HBM bytes, collective bytes by kind, loop-aware), and ``roofline``:
    ``launch.roofline`` of it on the H100 (for LM cells
    ``analyze_cell``, with the reference's token counts);
  * ``memory``: this rank's argument and output bytes (local blocks)
    and, on the card, its peak bytes (``torch.cuda.max_memory_allocated``
    after ``reset_peak_memory_stats``).

XLA's ``compile_s``, ``cost_analysis`` (its own FLOPs and bytes),
``hlo_lines`` and ``--keep-hlo`` have no counterpart and are not
recorded.  Usage:

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      [--multi-pod] [--microbatches 8] [--override num_layers=2] \\
      [--device cpu]
  python -m repro_torch.launch.dryrun --bfs rmat22-16 [--multi-pod] \\
      [--dispatch bitmap|queue] [--crossbar staged|flat] [--device cpu]
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--kind bfs|lm]
  python -m repro_torch.launch.dryrun --summary   # the LM records' table

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


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of the tensors in ``tree`` (dicts,
    lists, modules' parameters; DTensors by their local block)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            total += _local_bytes(t)
        elif isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def lower_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                  microbatches: int = 8, overrides: dict | None = None,
                  device=None) -> dict:
    """Run and count one step of an LM cell at rank 0 of the production
    mesh (see the module docstring); returns the cell's record, a
    ``"skipped"`` one where ``cell_is_applicable`` says so."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import (SHAPES, cell_is_applicable,
                                           input_specs)
    from repro_torch.launch.step_analysis import StepAnalysis
    from repro_torch.models.psharding import mesh_axes
    from repro_torch.models.transformer import abstract_params
    from repro_torch.train.step import (TrainConfig, abstract_train_state,
                                        build_prefill_step, build_serve_step,
                                        build_train_step)

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
        "kind": cell.kind, "overrides": overrides or {},
    }
    ok, why = cell_is_applicable(cfg, cell)
    if not ok:
        rec["skipped"] = why
        return rec

    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    on_card = mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card \
        else None
    n_dev = mesh.size()
    specs = input_specs(cfg, shape_name)
    if cell.kind == "train":
        st = abstract_train_state(cfg)
        rec["microbatches"] = microbatches
        fn, st_sh, b_sh = build_train_step(
            cfg, mesh, tcfg=TrainConfig(microbatches=microbatches),
            abstract_state=st, abstract_batch=specs["batch"])
        args = ({"params": sh.distribute_params(st["params"], mesh,
                                                zeros=on_card),
                 "opt": sh.place_tree(st["opt"], st_sh["opt"],
                                      zeros=on_card)},
                sh.place_tree(specs["batch"], b_sh, zeros=on_card))
        tokens = cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        ap = abstract_params(cfg)
        fn, _, b_sh = build_prefill_step(cfg, mesh, abstract_params=ap,
                                         abstract_batch=specs["batch"])
        args = (sh.distribute_params(ap, mesh, zeros=on_card),
                sh.place_tree(specs["batch"], b_sh, zeros=on_card))
        tokens = cell.global_batch * cell.seq_len
    else:  # decode
        ap = abstract_params(cfg)
        fn, _, c_sh = build_serve_step(cfg, mesh, abstract_params=ap,
                                       abstract_caches=specs["caches"],
                                       abstract_tokens=specs["tokens"])
        tok_sh = sh.NamedSharding(mesh, sh.batch_pspec(
            tuple(specs["tokens"].shape), mesh_axes(mesh)))
        # the last slot: every cache slot is read
        args = (sh.distribute_params(ap, mesh, zeros=on_card),
                sh.place_tree(specs["caches"], c_sh, zeros=on_card),
                sh.place(specs["tokens"], tok_sh, zeros=on_card),
                cell.seq_len - 1)
        tokens = cell.global_batch
    rec.update(n_devices=n_dev,
               device=torch.cuda.get_device_name(dev) if on_card else "meta",
               setup_s=time.perf_counter() - t0)

    with StepAnalysis() as a:
        out = fn(*args)
    arg_bytes = _local_bytes(args)
    out_bytes = _local_bytes(out)
    del out
    step_s = peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        del out
    per_dev = a.result()
    rec.update(
        step_s=step_s,
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes, "peak_bytes": peak},
        per_device=per_dev,
        roofline=roofline.analyze_cell(
            per_dev, cell.kind, float(cfg.active_param_count()),
            float(tokens), n_dev))
    return rec


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
    """(record path, CLI arguments) of every cell, the reference's list in
    its order: per mesh, every (arch x shape) LM cell, then the BFS cells
    (the five on the single pod, the default engine's three on two
    pods)."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.shapes import SHAPES
    cells = []
    for multi_pod in (False, True):
        tag = _mesh_tag(multi_pod)
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                path = os.path.join(out_dir, f"{arch}__{shape}__{tag}.json")
                args = ["--arch", arch, "--shape", shape]
                cells.append((path, args + (["--multi-pod"] if multi_pod
                                            else [])))
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
            timeout: float = 3000.0, jobs: int = 1,
            kind: str | None = None) -> int:
    """Run every cell not yet recorded under ``out_dir``, each in its own
    subprocess on ``device``, ``jobs`` of them at a time (only the
    ``"bfs"`` or ``"lm"`` cells with ``kind``); returns the number that
    failed.  A process's peak memory is its own, so cells that share the
    card still record their own peaks."""
    os.makedirs(out_dir, exist_ok=True)
    cells = [c for c in all_cells(out_dir)
             if kind is None or ("--bfs" in c[1]) == (kind == "bfs")]
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


def summary(out_dir: str) -> list[str]:
    """One line a recorded LM cell under ``out_dir``, in ``all_cells``'
    order: its dominant roofline term and ``roofline_fraction``, the
    counted FLOPs and bytes per device (counts of the program, not card
    times), or why it was skipped."""
    lines = []
    for path, args in all_cells(out_dir):
        if "--bfs" in args or not os.path.exists(path):
            continue
        with open(path) as f:
            rec = json.load(f)
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        if "skipped" in rec:
            lines.append(f"{name} | skipped: {rec['skipped']}")
            continue
        roof, per = rec["roofline"], rec["per_device"]
        lines.append(f"{name} | {roof['dominant']} | "
                     f"{roof['roofline_fraction']:.4f} | "
                     f"{per['flops']:.3e} | {per['bytes']:.3e} | "
                     f"{per['collective_bytes']:.3e}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
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
    ap.add_argument("--kind", choices=["bfs", "lm"], default=None,
                    help="--all: only the BFS or only the LM cells")
    ap.add_argument("--summary", action="store_true",
                    help="print one line a recorded LM cell under --out")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig field override, e.g. num_layers=2")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.isdigit() else v

    if args.summary:
        print("cell | dominant | roofline_fraction | flops | bytes | "
              "collective_bytes (per device)")
        print("\n".join(summary(args.out)))
        return 0
    if args.all:
        return 1 if run_all(args.out, args.device, jobs=args.jobs,
                            kind=args.kind) else 0
    if not args.bfs and not (args.arch and args.shape):
        ap.error("--arch and --shape, --bfs GRAPH or --all is required")
    try:
        if args.bfs:
            rec = lower_bfs_cell(args.bfs, args.multi_pod, args.dispatch,
                                 args.crossbar, device=args.device)
        else:
            rec = lower_lm_cell(args.arch, args.shape, args.multi_pod,
                                microbatches=args.microbatches,
                                overrides=overrides or None,
                                device=args.device)
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
