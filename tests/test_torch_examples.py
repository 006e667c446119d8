"""The port's three BFS examples (``examples/*_torch.py``) against the
reference's own (``examples/quickstart.py``, ``distributed_bfs.py``,
``serve_bfs_async.py``) on one small graph, and the public names of the
port's packages against the reference's.

Each reference example runs through its own code, unedited: imported
from its file, with ``get_dataset`` in its namespace swapped for the
small graph, its standard output captured and parsed (a printed
``last_stats`` dict is parsed as a literal, not compared as text).  The
port's example returns what it prints from ``run(graph=..., device=
"cpu")``.  Every structural field must be equal: iterations, the push /
pull split, ``last_stats``, the crossbar FIFO counts, the fake-clock
wave, the request counts and the oracle's verdict.  Times, TEPS and
GTEPS are not compared.  ``distributed_bfs`` runs on 4 gloo ranks
against the reference on 4 host devices: both take the 2-D mesh and the
staged crossbar over two axes.
"""
import ast
import contextlib
import importlib.util
import io
import json
import re
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax")

from repro.graph import get_dataset as j_get_dataset       # noqa: E402
from repro_torch.graph import get_dataset                  # noqa: E402
from test_torch_dispatcher import run_ranks, run_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
GRAPH = "small-12-8"
WORLD = 4                   # ranks of the distributed example


def load(name: str) -> types.ModuleType:
    """``examples/<name>.py`` imported as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def graph_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GRAPH_CACHE", str(tmp_path / "graphs"))
    return tmp_path


def reference_output(example, monkeypatch) -> str:
    """What the reference ``example``'s ``main()`` prints on GRAPH."""
    monkeypatch.setattr(example, "get_dataset",
                        lambda name: j_get_dataset(GRAPH))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        example.main()
    return out.getvalue()


def grab(pattern: str, text: str) -> tuple:
    m = re.search(pattern, text, re.MULTILINE)
    assert m, f"{pattern!r} not in:\n{text}"
    return m.groups()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference(graph_cache, monkeypatch):
    ref = load("quickstart")
    u280 = []

    def perf_total(*a, **k):
        u280.append(ref_perf_total(*a, **k))
        return u280[-1]

    ref_perf_total = ref.perf_total
    monkeypatch.setattr(ref, "perf_total", perf_total)
    text = reference_output(ref, monkeypatch)
    root, = grab(r"root=(\d+)$", text)
    iters, push, pull = grab(
        r"local hybrid BFS: (\d+) iters \((\d+) push / (\d+) pull\)", text)
    stats, = grab(r"stats=(\{.*\})$", text)

    got = load("quickstart_torch").run(graph=GRAPH, device="cpu")
    assert not dist.is_initialized()          # its own group is destroyed
    assert got["root"] == int(root)
    assert (got["local"]["iterations"], got["local"]["push_iters"],
            got["local"]["pull_iters"]) == (int(iters), int(push), int(pull))
    assert got["distributed"]["last_stats"] == ast.literal_eval(stats)
    assert got["distributed"]["shards"] == 4
    assert len(u280) == 1
    assert got["model"]["u280_gteps"] == pytest.approx(u280[0] / 1e9,
                                                       rel=1e-9, abs=0)


# ---------------------------------------------------------------------------
# distributed_bfs: 4 gloo ranks against 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE_DISTRIBUTED = """
import contextlib, importlib.util, io, sys
from repro.graph import get_dataset
spec = importlib.util.spec_from_file_location("distributed_bfs", sys.argv[1])
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
example.get_dataset = lambda name: get_dataset(sys.argv[2])
out = io.StringIO()
with contextlib.redirect_stdout(out):
    example.main()
with open(sys.argv[3], "w") as f:
    f.write(out.getvalue())
"""

_PORT_DISTRIBUTED = """
import importlib.util, json
spec = importlib.util.spec_from_file_location("distributed_bfs_torch",
                                              {path!r})
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
out = example.run({graph!r}, device="cpu")
with open(f"{{tmp}}/rank{{rank}}.json", "w") as f:
    json.dump(out, f)
"""

STATS = r"(\{.*\})$"


def test_distributed_bfs_matches_reference(graph_cache):
    tmp = graph_cache / "ranks"
    tmp.mkdir()
    get_dataset(GRAPH)                  # cached once, before the ranks
    ref_out = graph_cache / "reference.txt"
    body = _PORT_DISTRIBUTED.format(
        path=str(EXAMPLES / "distributed_bfs_torch.py"), graph=GRAPH)
    with ThreadPoolExecutor(2) as pool:
        ref_job = pool.submit(run_reference, _REFERENCE_DISTRIBUTED, WORLD,
                              str(EXAMPLES / "distributed_bfs.py"), GRAPH,
                              str(ref_out))
        port_job = pool.submit(run_ranks, body, WORLD, tmp)
        ref_job.result()
        port_job.result()
    text = ref_out.read_text()
    devices, mesh, shards = grab(r"devices=(\d+) mesh=(\{.*\}) shards=(\d+)",
                                 text)
    engines = re.findall(r"^\s+(\w+)\s*/(\w+)\s*: ok, .*GTEPS \(CPU\), "
                         + STATS, text, re.MULTILINE)
    full, layered = grab(r"64x64 full = (\d+) FIFOs, 3-layer 4x4 = (\d+)",
                         text)
    batch, = grab(r"MS-BFS batch=32: ok, .* " + STATS, text)
    want = dict(devices=int(devices), mesh=ast.literal_eval(mesh),
                shards=int(shards),
                engines=[(d, c, ast.literal_eval(s)) for d, c, s in engines],
                fifos=dict(full_64=int(full), layered_4x4x4=int(layered)),
                batch=ast.literal_eval(batch))
    assert want["mesh"] == {"data": 2, "model": 2} and len(engines) == 3
    for rank in range(WORLD):
        got = json.loads((tmp / f"rank{rank}.json").read_text())
        assert dict(devices=got["devices"], mesh=got["mesh"],
                    shards=got["shards"],
                    engines=[(e["dispatch"], e["crossbar"], e["last_stats"])
                             for e in got["engines"]],
                    fifos=got["fifos"],
                    batch=got["batch"]["last_stats"]) == want, rank


# ---------------------------------------------------------------------------
# serve_bfs_async
# ---------------------------------------------------------------------------

def test_serve_bfs_async_matches_reference(graph_cache, monkeypatch):
    text = reference_output(load("serve_bfs_async"), monkeypatch)
    batch, slots, iters = grab(r"batch=(\d+) slots=(\d+) iters=(\d+)", text)
    ok1, = grab(r"futures match bfs_oracle: (\w+)", text)
    requests, = grab(r"\[threaded\] (\d+) requests", text)
    reached, = grab(r"mean vertices reached per query: (\d+)", text)
    rejected, = grab(r"5th submit rejected: (.*)$", text)
    drained, = grab(r"drained waves: (\d+)", text)

    got = load("serve_bfs_async_torch").run(graph=GRAPH, device="cpu")
    s1, s2, s3 = got["scene1"], got["scene2"], got["scene3"]
    assert (s1["batch"], s1["n_slots"], s1["iterations"]) == (
        int(batch), int(slots), int(iters))
    assert ok1 == "True" and s1["oracle_match"] is True
    assert s2["stats"]["requests"] == int(requests)
    assert s2["oracle_match"] is True
    assert f"{s2['mean_reached']:.0f}" == reached
    assert s3["rejected"] == rejected
    assert s3["drained_waves"] == int(drained)


# ---------------------------------------------------------------------------
# no fallback to the CPU; the public names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["quickstart_torch", "distributed_bfs_torch",
                                  "serve_bfs_async_torch"])
def test_example_needs_the_card(name, graph_cache, monkeypatch):
    """Without ``--device cpu`` an example runs on the card, and raises
    where there is none; no process group is left behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])
    assert not dist.is_initialized()


# ``repro.kernels.bitmap_update`` is the one name whose kind differs: the
# reference's package binds its function and so shadows the module of
# that name; the port's package keeps the module (``chip_smoke.py`` and the
# kernel tests import it as ``kbu``), whose ``bitmap_update`` is the
# function.  ``repro.testing`` (the tests' hypothesis shim) has no
# counterpart.
PACKAGES = ["configs", "core", "ft", "graph", "kernels", "models"]


@pytest.mark.parametrize("package", PACKAGES)
def test_public_names_match_reference(package):
    """Every name the reference package exports (its ``__all__``, else
    its public names) exists in the port's package."""
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    names = getattr(ref, "__all__", None) or [
        k for k in vars(ref) if not k.startswith("_")]
    assert [k for k in names if not hasattr(port, k)] == []
    if package == "kernels":
        from repro_torch.kernels import bitmap_update as kbu
        assert isinstance(kbu, types.ModuleType)
        assert callable(kbu.bitmap_update)
