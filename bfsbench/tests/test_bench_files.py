"""Adding by files alone, and whole runs rehearsed end to end on the CPU at
a tiny test-only configuration (``conftest.bench_copy``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import re
from pathlib import Path

import numpy as np
import pytest
from conftest import ROOT, add_cell, run_tiny

CLOSED_E2E = {"teps", "setup_s"}


def test_new_files_are_found_by_name(bench_copy):
    """A configuration, a mix and a metric added as files, with their
    entries in BENCHMARK.json, run without an edit to any file that was
    there."""
    before = {p.relative_to(bench_copy): p.read_bytes()
              for p in bench_copy.rglob("*.py")}
    cfg = json.loads((bench_copy / "configs/tiny.json").read_text())
    (bench_copy / "configs/tiny2.json").write_text(
        json.dumps(dict(cfg, name="tiny2", edge_factor=4)))
    (bench_copy / "traffic/wave96.json").write_text(json.dumps(
        {"entry": "run_batch", "batch": 96, "runner": {}}))
    (bench_copy / "metrics/waves_done.py").write_text(
        "def read(run):\n    return float(len(run.ok_units)) or None\n")
    spec_path = bench_copy.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "tiny2.wave96", "config": "tiny2",
                              "traffic": "wave96", "chips": 1,
                              "why": "test only"})
    next(m for m in spec["end_to_end"] if m["name"] == "teps")[
        "workloads"].append("tiny2.wave96")
    spec["per_layer"].append({"name": "waves_done", "unit": "waves",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine loop", "moves": "teps",
                              "workloads": ["tiny2.wave96"]})
    spec_path.write_text(json.dumps(spec))
    out = run_tiny(bench_copy, "tiny2.wave96", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["waves_done"]["value"] >= 1
    assert out["metrics"]["waves_done"]["unit"] == "waves"
    assert out["attempted"] % 96 == 0
    after = {p.relative_to(bench_copy): p.read_bytes()
             for p in bench_copy.rglob("*.py") if p.name != "waves_done.py"}
    assert {k: v for k, v in after.items()
            if "__pycache__" not in k.parts} == {
        k: v for k, v in before.items() if "__pycache__" not in k.parts}


@pytest.mark.parametrize("cell", ["tiny.wave32", "tiny.single",
                                  "tiny.served"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_end_to_end(bench_copy, cell, trace):
    out = run_tiny(bench_copy, cell, seed=2**31 + 17, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["mismatched_levels"] == {"value": 0, "limit": 0}
    assert out["checks"]["rows_checked"]["value"] >= 1
    got = set(out["metrics"])
    served = cell.endswith("served")
    if not trace:
        assert got == ({"served_p95_ms", "setup_s"} if served
                       else CLOSED_E2E)
        assert "breakdown" not in out
    else:
        # no device on the CPU: the device-trace readers stay silent
        assert got == ({"batch_mean.served", "queue_ms_p50.served",
                        "dispatch_ms_p50.served", "service_ms_p50.served"}
                       if served else {"levels_ms", "readback_ms"})
        assert out["device"]["window_s"] > 0
        assert out["breakdown"]["device_ops"] == []
    for m in out["metrics"].values():
        assert m["value"] > 0


def test_same_seed_same_work(bench_copy):
    """The same seed gives the same roots in the same order."""
    from bfsbench import drive, harness
    a = drive.open_loop_schedule(40.0, 5.0, np.random.default_rng(3))
    b = drive.open_loop_schedule(40.0, 5.0, np.random.default_rng(3))
    c = drive.open_loop_schedule(40.0, 5.0, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert a.size == c.size and a[-1] == pytest.approx(c[-1])
    keys = np.arange(100, 200)
    d = drive.draw_distinct(keys, 64, np.random.default_rng(9))
    assert len(set(d.tolist())) == 64 and set(d.tolist()) <= set(keys)
    assert harness.metrics_of(harness.load_spec(ROOT), "kron22-16.wave64",
                              False)


def test_run_refuses_without_a_card(tmp_path):
    """No card: no result and a nonzero exit; nor a result in a directory
    that holds only BENCHMARK.json and the benchmark's files."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "bfsbench.run", "--workload",
           "kron22-16.wave64", "--seed", "3", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bfsbench", tmp_path / "bfsbench")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _snapshot(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


EACH_ROOT = '''"""each_root: a closed loop whose call runs ``BFSRunner.run`` over
each of ``batch`` roots in turn and stacks the level arrays."""
import numpy as np

from bfsbench import drive


class Entry:
    def __init__(self, g):
        from repro_torch.core.bfs_local import BFSRunner
        self.runner = BFSRunner(g)

    def __call__(self, roots):
        res = [self.runner.run(int(r)) for r in roots]
        return (np.stack([r.level for r in res]),
                sum(r.seconds for r in res))


def make(g, mix, keys, rng, tracer, entry=None):
    return drive.ClosedLoop(entry or Entry(g), int(mix["batch"]), keys,
                            rng, tracer)
'''


def test_new_loop_kind_by_files_alone(bench_copy):
    """A new kind of entry is a loop module and a mix that names it: the
    harness runs it with no edit to a file that was there."""
    root = bench_copy.parent
    before = _snapshot(bench_copy)
    (bench_copy / "loops/each_root.py").write_text(EACH_ROOT)
    add_cell(root, "tiny.each4", {"entry": "each_root", "batch": 4},
             per_layer=("levels_ms",))
    out = run_tiny(bench_copy, "tiny.each4", seed=2**31 + 5, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] % 4 == 0 and out["attempted"] > 0
    assert out["metrics"]["levels_ms"]["value"] > 0
    after = _snapshot(bench_copy)
    assert set(after) - set(before) == {
        Path("loops/each_root.py"), Path("traffic/each4.json")}
    assert all(after[k] == v for k, v in before.items())


def test_burst_mix_is_data_alone(bench_copy):
    """Bursts on and off are a mix file of phases for the batcher's loop."""
    mix = {"entry": "batcher", "runner": {},
           "phases": [{"rate": 400.0, "seconds": 0.1},
                      {"rate": 0.0, "seconds": 0.1}],
           "batcher": {"max_batch": 32, "window": 0.01, "pipeline": True}}
    add_cell(bench_copy.parent, "tiny.burst", mix,
             per_layer=("batch_mean.served",))
    out = run_tiny(bench_copy, "tiny.burst", seed=2**31 + 9, seconds=0.4)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["served_p95_ms"]["value"] > 0


def test_arrivals_by_phase():
    from bfsbench import drive
    one = {"rate": 40.0}
    a = drive.arrivals(one, 5.0, np.random.default_rng(3))
    np.testing.assert_array_equal(
        a, drive.open_loop_schedule(40.0, 5.0, np.random.default_rng(3)))
    burst = {"phases": [{"rate": 200.0, "seconds": 0.5},
                        {"rate": 0.0, "seconds": 1.5}]}
    b = drive.arrivals(burst, 8.0, np.random.default_rng(5))
    c = drive.arrivals(burst, 8.0, np.random.default_rng(5))
    d = drive.arrivals(burst, 8.0, np.random.default_rng(6))
    np.testing.assert_array_equal(b, c)
    assert b.size == d.size > 300
    assert np.all(np.diff(b) > 0) and b[-1] < 8.0
    assert np.all(b % 2.0 < 0.5)           # nothing in the quiet phases


def test_dispatch_stamped_by_wave_order():
    from bfsbench import drive
    reqs = [drive.Request(5, 0.0, ok=True, wave_id=0),
            drive.Request(9, 0.0, ok=True, wave_id=1),
            drive.Request(7, 0.0, ok=True, wave_id=1),
            drive.Request(3, 0.0, ok=True, wave_id=2),
            drive.Request(4, 0.0, ok=False, wave_id=0)]
    calls = [(1.0, np.array([5, 4, 5])), (2.0, np.array([9, 9]))]
    drive.stamp_dispatch(reqs, calls)
    assert [r.dispatch for r in reqs] == [1.0, 2.0, None, None, None]


def test_glue_leaves_out_the_port_kernels():
    from bfsbench.harness import load_metric
    glue = load_metric("glue_device_ms").is_glue
    assert not glue("void whole_scatter_kernel<2>(WholeArgs)")
    assert not glue("p3_planes_kernel(unsigned int const*, int)")
    assert not glue("void flash_tc_kernel<64>(CUtensorMap, CUtensorMap)")
    assert glue("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::CUDAFunctor_add<long>>(int, T1_, T2_)")
    assert glue("void new_port_kernel(int*)")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_spec_keeps_to_its_own_rules():
    """Every name, file and cross-reference in BENCHMARK.json: each cell
    reports setup_s, another end-to-end metric and a per-layer metric
    that moves one it reports; every metric, mix and loop has its file."""
    from bfsbench import harness
    spec = harness.load_spec(ROOT)
    bench = ROOT / "bfsbench"
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cfgs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and NAME.match(c["name"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for cell in spec["workloads"]:
        name = cell["name"]
        assert NAME.match(name) and cell["config"] in cfgs
        assert len(cell["why"]) <= 200 and cell["chips"] == 1
        mix = harness.read_mix(cell["traffic"])
        assert (bench / "loops" / f"{mix['entry']}.py").is_file()
        e2e = {m["name"] for m in harness.metrics_of(spec, name, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        layers = harness.metrics_of(spec, name, True)
        assert layers and all(m["moves"] in e2e for m in layers), name
