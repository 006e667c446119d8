"""The port's sharding rules, input shapes, test mesh and data pipeline
(``repro_torch.launch.{shardings,shapes,mesh}``,
``repro_torch.data.pipeline``) against the reference's, on the CPU.

Specs, shapes and dtypes are compared exactly; ``make_batch`` bit for
bit.  The full configs are abstract on both sides (the port's on the
``meta`` device, the reference's through ``jax.eval_shape``), so nothing
is allocated.  A reference spec is ``tuple(PartitionSpec)``; the port
holds a layer's tensor, the reference its segment's stack, whose
leading (layer) entry is None.
"""
import functools
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.models.transformer import reference_path  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

MESHES = {"1x1x1": {"pod": 1, "data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
JDT = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32}


def fake_mesh(shape: dict):
    """A mesh for the specs alone: its axis names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=shape,
                                 device_type="cpu")


@functools.lru_cache(maxsize=None)
def reference_param_specs(name: str, mesh: str) -> dict:
    """The reference's ``param_pspec`` of every leaf of the full config,
    keyed by its '/'-joined path."""
    from jax.tree_util import tree_flatten_with_path
    abstract = jax.eval_shape(functools.partial(
        jt.init_params, j_get_config(name)), jax.random.key(0))
    out = {}
    for path, leaf in tree_flatten_with_path(abstract)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = (tuple(jsh.param_pspec(path, leaf, MESHES[mesh])),
                    tuple(leaf.shape))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_equal_reference(name, mesh):
    want = reference_param_specs(name, mesh)
    state = tstep.abstract_train_state(get_config(name))
    assert all(p.device.type == "meta"
               for p in state["params"].parameters())
    shardings = tstep.state_shardings(state, fake_mesh(MESHES[mesh]))
    got = {}
    for pname, p in state["params"].named_parameters():
        path, layer = reference_path(pname)
        spec = shardings["params"][pname].spec
        assert len(spec) == p.dim()
        key = "/".join(path)
        got.setdefault(key, set()).add(
            ((None,) + spec, (None,) + tuple(p.shape)) if layer is not None
            else (spec, tuple(p.shape)))
        # optimizer moments share their parameter's spec
        assert shardings["opt"]["m"][pname].spec == spec
        assert shardings["opt"]["v"][pname].spec == spec
    assert shardings["opt"]["step"].spec == ()
    assert set(got) == set(want)
    for key, (spec, shape) in want.items():
        ((gspec, gshape),) = got[key]       # every layer alike
        assert gspec == spec, (key, gspec, spec)
        assert gshape[1:] == shape[1:] if gshape[0] is None else (
            gshape == shape), key
    if mesh != "1x1x1":
        assert any(any(e is not None for e in s) for s, _ in want.values())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_and_batch_cache_specs_equal_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    for cell_name, cell in tshapes.SHAPES.items():
        jcell = jshapes.SHAPES[cell_name]
        assert (cell.kind, cell.seq_len, cell.global_batch) == (
            jcell.kind, jcell.seq_len, jcell.global_batch)
        ok, why = tshapes.cell_is_applicable(cfg, cell)
        assert (ok, why) == jshapes.cell_is_applicable(jcfg, jcell)
        if not ok:
            continue
        got = tshapes.input_specs(cfg, cell_name)
        want = jshapes.input_specs(jcfg, cell_name)
        assert set(got) == set(want)
        gl = jax.tree.leaves(got, is_leaf=torch.is_tensor)
        wl, wdef = jax.tree.flatten(want)
        assert jax.tree.structure(got, is_leaf=torch.is_tensor) == wdef
        for g, w in zip(gl, wl):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert JDT[g.dtype] == w.dtype
        for mesh in MESHES.values():
            if "batch" in got:
                for k, v in got["batch"].items():
                    assert tsh.batch_pspec(tuple(v.shape), mesh) == tuple(
                        jsh.batch_pspec(tuple(v.shape), mesh)), (cell_name, k)
                b_sh = tsh.batch_shardings(got["batch"], fake_mesh(mesh))
                assert set(b_sh) == set(got["batch"])
            else:
                for joint in (False, True):
                    c_sh = tsh.cache_shardings(got["caches"], fake_mesh(mesh),
                                               joint)
                    for seg, sseg in zip(got["caches"], c_sh):
                        for k, v in seg.items():
                            assert sseg[k].spec == tuple(jsh.cache_pspec(
                                tuple(v.shape), mesh, joint)), (cell_name, k)


def test_pick_spec_matches_reference():
    rng = np.random.default_rng(0)
    axes = [("model",), ("data",), ("pod", "data"), ("model", "data")]
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 8, 16, 24, 32,
                                                  96], nd))
        prefs = [(int(rng.integers(0, nd)), axes[int(rng.integers(0, 4))])
                 for _ in range(int(rng.integers(0, 4)))]
        for mesh in MESHES.values():
            assert tsh.pick_spec(shape, prefs, mesh) == tuple(
                jsh.pick_spec(shape, prefs, mesh))


def test_place_on_one_rank():
    """One rank: ``place`` only moves the tensor.  More ranks (the 16x16
    production mesh over a fake group): a DTensor of the spec's
    placements, holding this rank's block (a ``meta`` one for a ``meta``
    tensor, zeros on the mesh's device with ``zeros=True``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = tmesh.make_test_mesh(device="cpu")
    t = torch.arange(6)
    assert tsh.place(t, tsh.NamedSharding(mesh, ("data",))) is t
    assert tsh.replicated(mesh).spec == ()
    assert tsh.param_shardings(None, mesh) is None
    big = tmesh.make_production_mesh(device="cpu")
    try:
        got = tsh.place(torch.arange(32), tsh.NamedSharding(big, ("data",)))
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == (Shard(0), Replicate())
        assert got.to_local().tolist() == [0, 1]          # rank 0's block
        spec = (None, "model")
        m = tsh.place(torch.empty((4, 64), device="meta"),
                      tsh.NamedSharding(big, spec))
        assert m.shape == (4, 64) and m.to_local().shape == (4, 4)
        assert m.to_local().is_meta
        z = tsh.place(torch.empty((4, 64), device="meta"),
                      tsh.NamedSharding(big, spec), zeros=True)
        assert not z.to_local().is_meta and not z.to_local().any()
    finally:
        dist.destroy_process_group()


def test_make_test_mesh_factors_like_the_reference(monkeypatch):
    """The greedy (pod, data, model) factorisation, n = 1..32; one rank
    with no process group is a ``LocalMesh``."""
    monkeypatch.setattr(jmesh, "_make", lambda shape, axes: (shape, axes))
    made = []
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda shape, axes, device=None: made.append(
                            (tuple(shape), tuple(axes))) or made[-1])
    for n in range(2, 33):
        assert tmesh.make_test_mesh(n, device="cpu") == jmesh.make_test_mesh(n)
    mesh = tmesh.make_test_mesh(device="cpu")
    assert isinstance(mesh, tmesh.LocalMesh)
    assert (mesh.mesh_dim_names, mesh.shape) == (("pod", "data", "model"),
                                                 (1, 1, 1))
    assert jmesh.make_test_mesh(1) == ((1, 1, 1), ("pod", "data", "model"))
    assert tmesh.mesh_device(mesh) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_test_mesh()


@pytest.mark.parametrize("kind", ["tokens", "embeds", "frames"])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_make_batch_bit_for_bit(kind, hosts):
    kw = dict(vocab_size=1000, global_batch=8, seq_len=24, seed=5,
              kind=kind, d_model=16, enc_len=12)
    jc, tc = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    for step in (0, 1, 17):
        for host in range(hosts):
            assert tpipe.host_slice(tc, host, hosts) == jpipe.host_slice(
                jc, host, hosts)
            got = tpipe.make_batch(tc, step, host, hosts)
            want = jpipe.make_batch(jc, step, host, hosts)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (kind, step, k)


def test_build_prefill_and_serve_steps():
    """The builders return the eager step beside its shardings: the same
    outputs as ``prefill_step`` / ``serve_step`` called directly, the
    param shardings keyed by parameter name, the cache shardings one
    dict a segment with the reference's specs."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as tt
    cfg = get_reduced_config("gemma3-4b")
    mesh = tmesh.make_test_mesh(device="cpu")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32))
    fn, p_sh, b_sh = tstep.build_prefill_step(
        cfg, mesh, tt.abstract_params(cfg), {"tokens": tokens})
    assert set(p_sh) == {k for k, _ in params.named_parameters()}
    assert b_sh["tokens"].spec == tuple(jsh.batch_pspec((2, 8),
                                                        MESHES["1x1x1"]))
    assert torch.equal(fn(params, {"tokens": tokens}),
                       tt.prefill_step(params, cfg, {"tokens": tokens}))
    caches = tt.init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    fn, p_sh, c_sh = tstep.build_serve_step(
        cfg, mesh, tt.abstract_params(cfg), caches, tokens[:, 0])
    assert [set(c) for c in c_sh] == [set(c) for c in caches]
    for seg, sseg in zip(caches, c_sh):
        for k, v in seg.items():
            assert sseg[k].spec == tuple(jsh.cache_pspec(
                tuple(v.shape), MESHES["1x1x1"]))
    got, got_caches = fn(params, caches, tokens[:, 0], 0)
    want, want_caches = tt.serve_step(params, cfg, caches, tokens[:, 0], 0)
    assert torch.equal(got, want)
    for a, b in zip(got_caches, want_caches):
        assert all(torch.equal(a[k], b[k]) for k in a)
