"""Run one cell: build the configuration's graph from the seed, hand it to
the program, warm the cell's shapes, measure the window, check a sample
of the answers against the plain reference, and reduce what was recorded
to the cell's metrics.

Everything that belongs to one configuration, mix, entry or metric is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json``, the
mix's ``loops/<entry>.py`` and ``metrics/<metric>.py`` under this folder;
``BENCHMARK.json`` beside it says which cell reports which metric.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from bfsbench import drive, kron, refbfs
from bfsbench.probe import Probe
from bfsbench.trace import Tracer

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Run:
    """What one run recorded; the metric readers' only input."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    units: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    trav: np.ndarray | None = None   # arcs a correct answer reaches, by root
    batcher: dict | None = None
    trace: object | None = None
    probe: Probe | None = None
    checks: dict = dataclasses.field(default_factory=dict)

    @property
    def ok_units(self) -> list:
        return [u for u in self.units if u.ok]


# -- finding things by name ----------------------------------------------------

def load_spec(root: Path = HERE.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def read_config(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def read_mix(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def load_metric(name: str, here: Path = HERE):
    """The reader module ``metrics/<name>.py``; its ``read(run)`` returns
    the metric's value, or None where it finds nothing to read."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bfsbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


# -- the run ---------------------------------------------------------------------

def build_graph(cfg: dict, seed: int, device: torch.device):
    """The configuration's graph for ``seed``, built on ``device``.
    Returns (host CSR arrays, host CSC arrays, arcs a correct answer
    reaches from each vertex); the device copies are freed."""
    csr, csc = kron.build_graph(cfg, seed, device)
    trav = kron.component_arcs(csr).cpu().numpy()
    host = kron.to_host(csr)
    host_t = host if csc is csr else kron.to_host(csc)
    del csr, csc
    _free(device)
    return host, host_t, trav


def program_graph(cfg: dict, host, host_t, device: torch.device):
    """The graph handed to the program: its ``LocalGraph`` built from the
    benchmark's arrays as ``CSRGraph``s."""
    from repro_torch.core.bfs_local import build_local_graph
    from repro_torch.graph.csr import CSRGraph
    n = 1 << int(cfg["scale"])
    return build_local_graph(CSRGraph(n, *host), CSRGraph(n, *host_t),
                             device=device)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, here: Path = HERE,
             make_entry=None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``make_entry(host_csr, device, mix)``, when given, builds what stands
    in the program's place (the control); the program is then not built."""
    spec = load_spec(here.parent)
    cell = cell_entry(spec, workload)
    run = Run(cell=cell, config=read_config(cell["config"], here),
              mix=read_mix(cell["traffic"], here), seed=seed, device=device)
    readers = [(m, load_metric(m["name"], here))
               for m in metrics_of(spec, workload, trace)]
    rng = np.random.default_rng(seed)
    host, host_t, run.trav = build_graph(run.config, seed, device)
    keys = np.flatnonzero(np.diff(host[0]) > 0)
    tracer = Tracer(trace, device)
    if make_entry is None:
        g = program_graph(run.config, host, host_t, device)
        loop = drive.make_loop(g, run.mix, keys, rng, tracer, here=here)
        del g
    else:
        loop = drive.make_loop(None, run.mix, keys, rng, tracer,
                               entry=make_entry(host, device, run.mix),
                               here=here)
    tracer.outer_label = loop.outer_label
    loop.warm()
    drive.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_process
    sample = drive.Reservoir(drive.SAMPLE, np.random.default_rng([seed, 1]))
    if trace:
        run.probe = loop.counter = Probe(tracer, device).install()
    tracer.start()
    try:
        recorded = loop.window(seconds, sample)
    finally:
        run.trace = tracer.stop()
        if run.probe is not None:
            run.probe.remove()
    if loop.open_loop:
        run.requests = recorded
        run.batcher = loop.stats()
        done = [r.done for r in recorded if r.done is not None]
        run.window_s = max(done, default=0.0) - min(
            (r.due for r in recorded), default=0.0)
    else:
        run.units = recorded
        run.window_s = recorded[-1].t1 - recorded[0].t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loop.close()
    del loop
    _free(device)
    run.checks = check_answers(run, host, sample)
    return result(run, readers, peak, trace)


def check_answers(run: Run, host, sample: drive.Reservoir) -> dict:
    """The comparison that decides ``correct``: the sampled answers
    against the reference, and every answer due in the window accounted
    for."""
    indptr = torch.from_numpy(host[0]).to(run.device)
    indices = torch.from_numpy(host[1]).to(run.device)
    bad = sum(refbfs.mismatches(indptr, indices, root, row)
              for root, row in sample.items)
    if run.units:
        attempted = sum(len(u.roots) for u in run.units)
        missing = sum(len(u.roots) for u in run.units if not u.ok)
    else:
        attempted = len(run.requests)
        missing = sum(1 for r in run.requests if not r.ok)
    return {"attempted": attempted, "unanswered": missing,
            "mismatched_levels": bad, "rows_checked": len(sample.items)}


# Each number compared and its limit: (value <= limit) or, for
# rows_checked, (value >= limit).
LIMITS = {"mismatched_levels": 0, "unanswered": 0}
AT_LEAST = {"rows_checked": 1}


def verdict(checks: dict) -> tuple[bool, dict]:
    shown = {}
    ok = True
    for name, limit in LIMITS.items():
        shown[name] = {"value": checks[name], "limit": limit}
        ok &= checks[name] <= limit
    for name, limit in AT_LEAST.items():
        shown[name] = {"value": checks[name], "at_least": limit}
        ok &= checks[name] >= limit
    return bool(ok), shown


def result(run: Run, readers, peak: int, trace: bool) -> dict:
    correct, shown = verdict(run.checks)
    metrics = {}
    for entry, mod in readers:
        value = mod.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.checks["attempted"],
           "failed": run.checks["unanswered"], "metrics": metrics,
           "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_ns() / 1e9
        device["window_s"] = run.trace.window_ns() / 1e9
        out["breakdown"] = {"device_ops": run.trace.by_name(),
                            "idle_gaps": run.trace.idle_by_label()}
    out["checks"] = shown
    return out
