"""The dry-run's LM cells (``repro_torch.launch.dryrun.lower_lm_cell``)
and ``StepAnalysis`` of DTensor programs, on the CPU.

The cells run at full width cut to 2 layers (``num_layers=2``), one
microbatch, with ``device="cpu"``: rank 0 of the production mesh over a
fake process group, every block ``meta``.  Their argument bytes are held
to the reference's spec arithmetic (``param_pspec`` / ``cache_pspec`` /
``batch_pspec``: each leaf's block on one device, no compile) and their
``model_flops_total`` to the reference's ``roofline.model_flops``.  The
counts of a (data, model)-split MLP block on a fake 16x16 group are held
to a hand count at the rank's shapes.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.step_analysis import StepAnalysis  # noqa: E402
from repro_torch.models import psharding as psh  # noqa: E402

LAYERS = {"num_layers": 2}
MESH_SHAPES = {False: {"data": 16, "model": 16},
               True: {"pod": 2, "data": 16, "model": 16}}
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "overrides", "n_devices",
               "device", "setup_s", "step_s", "memory", "per_device",
               "roofline"}
CELLS = [("llama3-8b", "decode_32k", False),
         ("llama3-8b", "train_4k", False),
         ("mamba2-370m", "long_500k", True)]


@pytest.fixture(autouse=True)
def no_group_after():
    """Each cell starts its own fake group; later tests need none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_bytes(tree, pspec_of, mesh_shape) -> int:
    """Sum over ``tree``'s leaves of the bytes of one device's block under
    the reference's spec ``pspec_of(path, leaf)``."""
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        spec = pspec_of(path, leaf)
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (
                len(leaf.shape) - len(tuple(spec)))):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            split = math.prod(mesh_shape[a] for a in axes)
            assert dim % split == 0
            n *= dim // split
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def reference_argument_bytes(arch, shape, multi_pod) -> int:
    """One device's argument bytes of the reference's cell, from its
    specs: the state or params, then the batch, or caches and tokens."""
    import dataclasses
    cfg = dataclasses.replace(j_get_config(arch), **LAYERS)
    ms = MESH_SHAPES[multi_pod]
    cell = jshapes.SHAPES[shape]
    specs = jshapes.input_specs(cfg, shape)
    par = lambda p, leaf: jsh.param_pspec(p, leaf, ms)   # noqa: E731
    bat = lambda p, leaf: jsh.batch_pspec(leaf.shape, ms)  # noqa: E731
    if cell.kind == "train":
        st = jstep.abstract_train_state(cfg)
        return (_local_bytes(st["params"], par, ms)
                + _local_bytes(st["opt"]["m"], par, ms)
                + _local_bytes(st["opt"]["v"], par, ms)
                + _local_bytes(st["opt"]["step"], lambda p, x: (), ms)
                + _local_bytes(specs["batch"], bat, ms))
    params = jt.abstract_params(cfg)
    if cell.kind == "prefill":
        return (_local_bytes(params, par, ms)
                + _local_bytes(specs["batch"], bat, ms))
    return (_local_bytes(params, par, ms)
            + _local_bytes(specs["caches"],
                           lambda p, x: jsh.cache_pspec(x.shape, ms), ms)
            + _local_bytes(specs["tokens"], bat, ms))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_lm_cell_on_meta_matches_reference_specs(arch, shape, multi_pod):
    import dataclasses
    rec = dryrun.lower_lm_cell(arch, shape, multi_pod, microbatches=1,
                               overrides=LAYERS, device="cpu")
    want_keys = RECORD_KEYS | ({"microbatches"} if rec["kind"] == "train"
                               else set())
    assert set(rec) == want_keys
    assert rec["device"] == "meta" and rec["step_s"] is None
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    mem = rec["memory"]
    assert mem["peak_bytes"] is None and mem["output_size_in_bytes"] > 0
    assert mem["argument_size_in_bytes"] == reference_argument_bytes(
        arch, shape, multi_pod)
    cfg = dataclasses.replace(j_get_config(arch), **LAYERS)
    cell = jshapes.SHAPES[shape]
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    assert rec["roofline"]["model_flops_total"] == jroofline.model_flops(
        cell.kind, float(cfg.active_param_count()), float(tokens))
    per = rec["per_device"]
    assert per["flops"] > 0 and per["bytes"] > 0
    assert per["collective_count"] > 0
    assert set(per["collective_by_op"]) <= {"all-gather", "all-reduce",
                                            "reduce-scatter", "all-to-all"}


def test_skipped_long_context_cell():
    rec = dryrun.lower_lm_cell("llama3-8b", "long_500k", False,
                               overrides=LAYERS, device="cpu")
    assert rec == {"arch": "llama3-8b", "shape": "long_500k",
                   "mesh": "16x16", "kind": "decode", "overrides": LAYERS,
                   "skipped": "pure full-attention arch: 500k decode "
                              "skipped"}
    assert not dist.is_initialized()


def test_sharded_mlp_counts_at_local_shapes():
    """x [B, S, d] split by batch over data; w_up [d, f] and w_down [f, d]
    split over model (f) and data (d, FSDP): psharding.einsum gathers
    each weight over data, multiplies the rank's blocks, and the output's
    partial sum over model is all-reduced."""
    mesh = make_production_mesh(device="cpu")
    b, s, d, f = 256, 8, 512, 1024
    bl, dl, fl = b // 16, d // 16, f // 16
    bf16 = torch.bfloat16

    def dt(shape, pl):
        return DTensor.from_local(torch.empty(shape, dtype=bf16,
                                              device="meta"), mesh, pl,
                                  run_check=False)

    x = dt((bl, s, d), (Shard(0), Replicate()))
    w_up = dt((dl, fl), (Shard(0), Shard(1)))
    w_down = dt((fl, dl), (Shard(1), Shard(0)))
    with StepAnalysis() as a:
        h = psh.einsum("bsd,df->bsf", x, w_up)
        y = psh.einsum("bsf,fd->bsd", h, w_down)
        y = y.redistribute(mesh, (Shard(0), Replicate()))
    r = a.result()
    assert y.to_local().shape == (bl, s, d)
    m = bl * s
    assert r["flops"] == 2 * m * d * fl + 2 * m * fl * d
    ag = 2 * (dl * fl * 2)                     # each weight's block, bf16
    ar = m * d * 2
    assert r["collective_by_op"] == {"all-gather": ag, "all-reduce": ar}
    assert r["collective_count"] == 3
    assert r["collective_bytes"] == ag + ar
    # each local product reads its blocks and writes its result once; a
    # collective reads its input and writes its output; w_down's gather
    # along its dim 1 lands along dim 0 and one cat (a read and a write
    # of the gathered block) puts it in place
    mm = (m * d + d * fl + m * fl) * 2 + (m * fl + fl * d + m * d) * 2
    coll = (dl * fl + d * fl) * 2 * 2 + 2 * ar
    cat = fl * d * 2 * 2
    assert r["bytes"] == mm + coll + cat


def test_plain_program_counts_as_before():
    """The same product on plain tensors: the rules of before."""
    x = torch.empty((16, 8, 512), dtype=torch.bfloat16, device="meta")
    w = torch.empty((512, 64), dtype=torch.bfloat16, device="meta")
    with StepAnalysis() as a:
        psh.einsum("bsd,df->bsf", x, w)
    r = a.result()
    assert r["flops"] == 2 * 128 * 512 * 64
    assert r["bytes"] == (128 * 512 + 512 * 64 + 128 * 64) * 2
    assert r["collective_count"] == 0
