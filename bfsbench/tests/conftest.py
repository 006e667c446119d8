"""CPU tests of the benchmark.  Run from the repository's root:

    python -m pytest bfsbench/tests -q

Tests that need the card are marked ``cuda`` and skip inside a fixture.
``bench_copy`` gives a copy of the benchmark's files in a temporary
directory with a tiny test-only configuration and three cells on it
(reporting ``teps`` and the wave cells' per-layer metrics when closed),
which the harness runs on the CPU through the program's plain paths.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "name": "tiny", "generator": "graph500_kronecker", "scale": 9,
    "edge_factor": 8, "initiator": [0.57, 0.19, 0.19, 0.05],
    "undirected": True, "permute_vertices": True, "self_loops": "dropped",
    "duplicates": "merged", "source": "test only", "reduced": {},
}
TINY_CELLS = {
    "tiny.wave32": {"entry": "run_batch", "batch": 32, "runner": {}},
    "tiny.single": {"entry": "bfs_runner", "batch": 1, "runner": {}},
    "tiny.served": {"entry": "batcher", "rate": 200.0, "runner": {},
                    "batcher": {"max_batch": 32, "window": 0.01,
                                "pipeline": True}},
}


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def add_cell(root: Path, cell: str, mix: dict, per_layer=()) -> None:
    """Add ``cell`` (``<config>.<mix>``) to the copy at ``root``: the mix's
    file and the BENCHMARK.json entries, and each per-layer metric's
    ``workloads``."""
    config, traffic = cell.split(".", 1)
    (root / "bfsbench/traffic" / f"{traffic}.json").write_text(
        json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "test only"})
    closed = mix["entry"] != "batcher"
    for m in spec["end_to_end"]:
        if "workloads" in m and (m["name"] == "teps") == closed:
            m["workloads"].append(cell)
    for m in spec["per_layer"]:
        if m["name"] in per_layer:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of BENCHMARK.json and bfsbench/ with the tiny cells added;
    returns the copy's ``bfsbench`` folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bfsbench", tmp_path / "bfsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "bfsbench/configs/tiny.json").write_text(json.dumps(TINY))
    closed_layers = ("levels_ms", "readback_ms", "glue_device_ms",
                     "idle_share")
    served_layers = ("batch_mean.served", "queue_ms_p50.served",
                     "dispatch_ms_p50.served", "service_ms_p50.served",
                     "idle_share.served")
    for cell, mix in TINY_CELLS.items():
        add_cell(tmp_path, cell, mix, served_layers
                 if mix["entry"] == "batcher" else closed_layers)
    return tmp_path / "bfsbench"


def run_tiny(here: Path, cell: str, seed: int = 5, seconds: float = 0.4,
             trace: bool = False, make_entry=None) -> dict:
    import time

    import torch

    from bfsbench import harness
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), here=here,
                            make_entry=make_entry)
