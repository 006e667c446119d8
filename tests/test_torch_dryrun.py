"""The port's dry-run (``repro_torch.launch.dryrun``): the abstract engine
of ``DistributedBFS.abstract`` on the production meshes against the
reference's shard arithmetic, the cell list against the reference's
whole list, one BFS cell run end to end on the CPU and one LM cell
against the reference's compiled one (the LM cells' own tests are in
``test_torch_lm_dryrun.py``)."""
import json
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import torch.distributed as dist                             # noqa: E402

from repro.core.bfs_distributed import DistConfig as JConfig  # noqa: E402
from repro.core.bfs_distributed import DistributedBFS as JEngine  # noqa: E402
from repro.graph.datasets import DATASETS                    # noqa: E402
from repro_torch.core.bfs_distributed import (DistConfig,    # noqa: E402
                                              DistributedBFS)
from repro_torch.launch import dryrun                        # noqa: E402
from repro_torch.launch.mesh import make_production_mesh     # noqa: E402
from test_torch_dispatcher import _env                       # noqa: E402

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(g, d, x, mp) for mp in (False, True)
         for g, d, x in dryrun.BFS_CELLS]
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "num_vertices",
               "verts_per_shard", "shards", "edge_budget", "n_devices",
               "device", "setup_s", "push", "pull"}


@pytest.fixture
def production_mesh():
    """A function giving the production mesh over a fake process group,
    destroyed after the test (later tests in this process start their
    own groups)."""
    yield lambda multi_pod: make_production_mesh(multi_pod=multi_pod,
                                                 device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference(graph: str, dispatch: str, crossbar: str, multi_pod: bool):
    """The reference's abstract engine and input specs; its
    ``abstract()`` reads only ``mesh.axis_names`` and ``mesh.shape``."""
    shape, axes = MESHES[multi_pod]
    mesh = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))
    meta = DATASETS[graph]
    eng = JEngine.abstract(mesh, 1 << meta.scale, cfg=JConfig(
        dispatch=dispatch, crossbar=crossbar))
    return eng, eng.abstract_inputs(
        avg_degree=meta.edge_factor * (1 if meta.directed else 2))


@pytest.mark.parametrize("graph,dispatch,crossbar,multi_pod", CELLS)
def test_abstract_engine_equals_reference(production_mesh, graph, dispatch,
                                          crossbar, multi_pod):
    jeng, jsds = _reference(graph, dispatch, crossbar, multi_pod)
    meta = DATASETS[graph]
    eng = DistributedBFS.abstract(
        production_mesh(multi_pod), 1 << meta.scale,
        cfg=DistConfig(dispatch=dispatch, crossbar=crossbar))
    assert (eng.q, eng.k, eng.vl, eng.wl, eng.n_pad, eng.d) == (
        jeng.q, jeng.k, jeng.vl, jeng.wl, jeng.n_pad, jeng.d)
    assert eng.q == np.prod(MESHES[multi_pod][0])
    sds = eng.abstract_inputs(
        avg_degree=meta.edge_factor * (1 if meta.directed else 2))
    assert sds["lvl"] == 0 and jsds["lvl"].shape == ()
    for name in ("frontier", "visited", "level", "indptr", "indices"):
        got, want = sds[name], jsds[name]
        # this rank's block of the reference's global [q, ...] array
        assert tuple(got.shape) == (want.shape[0] // eng.d,
                                    *want.shape[1:]), name
        assert got.element_size() == want.dtype.itemsize, name
        assert not got.any(), name
    assert eng.out_indices is sds["indices"] and \
        eng.in_indptr is sds["indptr"]


def test_cells_equal_reference_bfs_cells(tmp_path):
    """The whole cell list, LM and BFS cells on both meshes, in the
    reference's order and with its record paths."""
    code = ("import json, sys\n"
            "from repro.launch.dryrun import all_cells\n"
            "print(json.dumps(all_cells(sys.argv[1])))\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = [tuple(c) for c in json.loads(r.stdout)]
    assert dryrun.all_cells(str(tmp_path)) == want
    assert len(want) == 88
    assert sum("--bfs" in c[1] for c in want) == 8


def test_lm_cell_against_reference_compile(tmp_path, production_mesh):
    """llama3.2-3b decode_32k on 16x16 cut to 2 layers: the reference
    lowers and compiles it (in a subprocess: its dry-run sets a
    512-device ``XLA_FLAGS`` at import); the port's cell on ``meta`` has
    its argument bytes (the reference's also hold ``pos``, an int32
    scalar the port's step takes as a host int) and FLOPs within 10% of
    its per-device count (both count dot FLOPs alone)."""
    code = ("import json\n"
            "from repro.launch.dryrun import lower_lm_cell\n"
            "r = lower_lm_cell('llama3.2-3b', 'decode_32k', False, "
            "overrides={'num_layers': 2})\n"
            "print(json.dumps([r['memory_analysis'], r['per_device']]))\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mem, per = json.loads(r.stdout.strip().splitlines()[-1])
    rec = dryrun.lower_lm_cell("llama3.2-3b", "decode_32k", False,
                               overrides={"num_layers": 2}, device="cpu")
    assert rec["memory"]["argument_size_in_bytes"] + 4 == \
        mem["argument_size_in_bytes"]
    got, want = rec["per_device"]["flops"], per["flops"]
    assert abs(got - want) <= 0.1 * want, (got, want)


def test_one_cell_end_to_end_on_cpu(tmp_path):
    path = tmp_path / "cell.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--bfs",
         "rmat16-16", "--dispatch", "queue", "--multi-pod", "--device",
         "cpu", "--json-out", str(path)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(path.read_text())
    assert set(rec) == RECORD_KEYS
    jeng, jsds = _reference("rmat16-16", "queue", "staged", True)
    assert (rec["shards"], rec["verts_per_shard"], rec["edge_budget"],
            rec["num_vertices"], rec["n_devices"]) == (
        jeng.q, jeng.vl, jsds["indices"].shape[1], 1 << 16, 512)
    assert (rec["arch"], rec["mesh"], rec["kind"], rec["device"]) == (
        "scalabfs-queue-staged", "2x16x16", "bfs", "cpu")
    for phase in ("push", "pull"):
        p = rec[phase]
        assert set(p) == {"step_s", "per_device", "roofline", "memory"}
        assert p["step_s"] > 0
        per = p["per_device"]
        assert set(per) == {"flops", "bytes", "collective_bytes",
                            "collective_count", "collective_by_op"}
        assert per["flops"] == 0 and per["bytes"] > 0
        assert p["roofline"]["bound_s"] > 0
        mem = p["memory"]
        assert mem["peak_bytes"] is None
        assert mem["argument_size_in_bytes"] == 4 * (
            2 * jeng.wl + jeng.vl + jeng.vl + 1 + jsds["indices"].shape[1])
        assert mem["output_size_in_bytes"] > 0
    # the push's queue FIFOs cross one all-to-all, its sums one all-reduce;
    # the pull all-gathers the frontier
    assert rec["push"]["per_device"]["collective_by_op"] == {
        "all-to-all": 512 * 4096 * 4, "all-reduce": 12.0}
    assert rec["pull"]["per_device"]["collective_by_op"] == {
        "all-gather": 4.0 * jeng.wl, "all-reduce": 8.0}
