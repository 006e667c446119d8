"""The port's serving entry points against the reference's, the device
rule, and the port's independence from JAX and from ``repro``."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch                                               # noqa: E402

from repro.launch import serve as jserve                   # noqa: E402
from repro_torch import resolve_device                     # noqa: E402
from repro_torch.launch import serve                       # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
GRAPH = "small-12-8"


@pytest.fixture
def graph_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path))
    return tmp_path


def test_bfs_batch_matches_reference(graph_cache):
    roots = np.asarray([0, 5, 5, 100, 4095, 17, 2048])      # duplicates ok
    engine, deg = serve.build_engine(GRAPH, device="cpu")
    got = serve.bfs_batch(roots, engine=engine, out_deg=deg)
    want = jserve.bfs_batch(roots, graph=GRAPH)
    np.testing.assert_array_equal(got["levels"], want["levels"])
    np.testing.assert_array_equal(got["levels"][1], got["levels"][2])
    for k in ("iterations", "push_iters", "pull_iters", "edges_inspected",
              "traversed_edges", "batch", "host_transfers", "budget",
              "overflow_retries", "algo"):
        assert got[k] == want[k], k
    # the engine-less call builds its own engine on the given device
    again = serve.bfs_batch(roots, graph=GRAPH, device="cpu")
    np.testing.assert_array_equal(again["levels"], want["levels"])


def test_serve_bfs_matches_reference(graph_cache):
    got = serve.serve_bfs(GRAPH, 33, device="cpu", keep_levels=True)
    want = jserve.serve_bfs(GRAPH, 33)
    for k in ("iterations", "push_iters", "pull_iters", "edges_inspected",
              "traversed_edges", "batch", "host_transfers", "reached_mean",
              "graph", "algo"):
        assert got[k] == want[k], k
    assert got["host_transfers"] == got["iterations"] + 2
    assert got["levels"].shape == (33, 4096)
    assert len(got["level_seconds"]) == got["iterations"]
    ref = jserve.bfs_batch(got["roots"], graph=GRAPH)["levels"]
    np.testing.assert_array_equal(got["levels"], ref)


def test_roots_validated(graph_cache):
    engine, deg = serve.build_engine(GRAPH, device="cpu")
    for bad in ([0, 4096], [-1], [1.5], []):
        with pytest.raises(ValueError):
            serve.bfs_batch(np.asarray(bad), engine=engine, out_deg=deg)
    # an unknown program is refused as the reference's get_program does;
    # cc and sssp build (their answers: tests/test_torch_programs.py)
    with pytest.raises(ValueError):
        serve.build_engine(GRAPH, algo="pagerank", device="cpu")
    for algo in ("cc", "sssp"):
        eng, _ = serve.build_engine(GRAPH, algo=algo, device="cpu")
        assert eng.program.name == algo


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group, destroyed after."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("algo", ["bfs", "cc"])
def test_distributed_engine_matches_local_runner(graph_cache, one_rank,
                                                 algo):
    """``build_engine(distributed=True)`` in a one-rank group: the
    distributed engine over 2 shards (2 PEs per PC), whose rows equal the
    local runner's and whose stats equal the reference's distributed
    engine's; ``distributed=None`` with one rank builds the local runner."""
    from repro_torch.core.bfs_distributed import DistributedBFS
    roots = np.asarray([0, 5, 5, 100, 4095, 17])
    engine, deg = serve.build_engine(GRAPH, algo=algo, distributed=True,
                                     device="cpu")
    assert isinstance(engine, DistributedBFS)
    assert (engine.q, engine.k, engine.program.name) == (2, 2, algo)
    local, deg_local = serve.build_engine(GRAPH, algo=algo, device="cpu")
    assert not isinstance(local, DistributedBFS)
    np.testing.assert_array_equal(deg, deg_local)
    got = serve.bfs_batch(roots, engine=engine, out_deg=deg)
    want = serve.bfs_batch(roots, engine=local, out_deg=deg)
    np.testing.assert_array_equal(got["levels"], want["levels"])
    assert got["traversed_edges"] == want["traversed_edges"]
    jeng, jdeg = jserve.build_engine(GRAPH, algo=algo, distributed=True)
    ref = jserve.bfs_batch(roots, engine=jeng, out_deg=jdeg)
    np.testing.assert_array_equal(got["levels"], ref["levels"])
    for k in ("iterations", "push_iters", "pull_iters", "edges_inspected",
              "traversed_edges", "batch", "algo"):
        assert got[k] == ref[k], k


def test_build_bfs_engine_matches_reference(graph_cache, one_rank):
    engine, deg = serve.build_bfs_engine(GRAPH, distributed=True,
                                         pes_per_device=4, device="cpu")
    jeng, jdeg = jserve.build_bfs_engine(GRAPH, distributed=True,
                                         pes_per_device=4)
    assert engine.q == jeng.q == 4
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_array_equal(engine.run_batch([3, 9]),
                                  jeng.run_batch([3, 9]))
    # the reference's counts; the port adds timings and byte counters
    assert {k: engine.last_stats[k] for k in jeng.last_stats} == \
        jeng.last_stats


def test_distributed_engine_needs_a_process_group(graph_cache):
    with pytest.raises(RuntimeError, match="init_process_group"):
        serve.build_engine(GRAPH, distributed=True, device="cpu")


def test_cli_prints_one_json_line(graph_cache, capsys):
    serve.main(["--bfs-graph", GRAPH, "--bfs-batch", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["batch"] == 8 and out["graph"] == GRAPH
    assert out["host_transfers"] == out["iterations"] + 2


def test_resolve_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        serve.build_engine(GRAPH)          # device=None means the card


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_repro():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax_or_repro():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(%r))\n" % (mods,))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is
    no CUDA device, and when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
