"""The training driver across ranks (``repro_torch.launch.train`` inside a
started process group) on 4 gloo ranks, against the one-rank driver, the
reference's driver on 4 host devices and the reference's checkpoints, on
the CPU.

The reduced llama3.2-3b, a global batch of 4 x 16 tokens in 2
microbatches; on 4 ranks ``make_test_mesh`` is (pod 1, data 1, model 4)
in both packages.  One group of 4 ranks runs every multi-rank scenario,
one group of 2 ranks restores, and the reference's driver runs meanwhile
in a subprocess of 4 host devices:

(a) ``train()`` in float32 on 4 ranks against one rank: each step's loss
    within 1e-4 + 1e-4·|want|, its grad_norm within 1e-4 relatively (as
    ``test_torch_lm_sharded.py``); the checkpoints hold the same keys,
    dtypes and shapes;
(b) the bf16 driver on 4 ranks with injected failures ends in the clean
    4-rank run's checkpoint bit for bit, the replayed steps logging what
    the first pass logged, every rank the same;
(c) elastic restore: the 4-rank checkpoint restores on 1 rank, on 2
    ranks and in the reference with the same bits; the reference's
    checkpoint and a one-rank one restore on 4 ranks, every parameter a
    ``DTensor`` whose block is its slice of the whole leaf, and saved
    again from 4 ranks they are the same file content, bit for bit;
(d) the port's 4-rank driver against the reference's on 4 host devices,
    both from the reference's float32 weights, 2 steps, (a)'s tolerance;
(e) grad compression of sharded grads equals one rank's bit for bit: q,
    the scales and the state after an AdamW step on them; a compressed
    sharded train step within (a)'s tolerance of one rank's;
(f) ``main()`` inside a started group prints only on rank 0, and under
    torchrun it starts its own group and ends it.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_reduced_config as j_get_reduced  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import compress  # noqa: E402
from test_torch_ckpt import bits, reference_state, same_bits  # noqa: E402
from test_torch_dispatcher import _env, _rank_env, run_ranks  # noqa: E402

ARCH = "llama3.2-3b"
STEPS_A, EVERY_A = 6, 3          # (a): float32, one checkpoint at 3 and 6
STEPS_B, EVERY_B = 10, 2         # (b): as test_torch_ckpt.py's replay test
FAILS = [(3,), (1,), (3, 8)]     # after a checkpoint, before one, twice
STEPS_D = 2
D_CASES = [(ARCH, {}), ("qwen3-moe-30b-a3b", {"moe_dispatch": "ep"})]
REF_STEP = 7                     # the reference-written state's step
GRAD_SCALE = 1e-4                # (e): the grads' norm stays under the clip
TIMEOUT = 300

# the float32 init and the unrounded metrics, for the test and the ranks
_SHARED = '''
import contextlib
from unittest import mock
import torch
from repro_torch.launch import train as T
from repro_torch.train import step as tstep

RUN = dict(arch="llama3.2-3b", reduced=True, global_batch=4, seq_len=16,
           microbatches=2, device="cpu")


def f32_init(cfg, run, dev):
    """The driver's draw from ``run.seed``, in float32."""
    return tstep.init_train_state(
        cfg, torch.Generator(dev).manual_seed(run.seed), torch.float32)


@contextlib.contextmanager
def recorded():
    """Each step's unrounded [total_loss, grad_norm] while inside."""
    got = []
    build = T.build_train_step

    def wrapped(*a, **k):
        fn, st_sh, b_sh = build(*a, **k)

        def step(state, batch):
            state, m = fn(state, batch)
            got.append([T._value(m["total_loss"]), T._value(m["grad_norm"])])
            return state, m
        return step, st_sh, b_sh

    with mock.patch.object(T, "build_train_step", wrapped):
        yield got
'''
SHARED: dict = {}
exec(_SHARED, SHARED)

_RANKS = """
import dataclasses, io, pickle
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import adamw
from repro_torch.train import compress
SHARED

DATA = "DATA_DIR"             # the inputs and outputs, shared by both groups
cfg = get_reduced_config("llama3.2-3b")
mesh = make_test_mesh(device="cpu")
out = {"mesh": list(mesh.shape)}
with open(f"{DATA}/ref_params0.pkl", "rb") as f:
    ref_params = pickle.load(f)


def ref_init(cfg, run, dev):
    params = lm_params_from_numpy(ref_params, cfg, torch.float32, "cpu")
    return {"params": params, "opt": adamw.init_state(params)}


def np_bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def block_of(whole, t):
    '''``whole``'s block that ``t``'s placements give this rank.'''
    shape, start = list(whole.shape), [0] * whole.ndim
    for i, p in enumerate(t.placements):
        if p.is_shard():
            shape[p.dim] //= t.device_mesh.size(i)
            start[p.dim] += t.device_mesh.get_local_rank(i) * shape[p.dim]
    return whole[tuple(slice(s, s + n) for s, n in zip(start, shape))]


def restore_report(src, step, dtype):
    '''Restore ``src`` at ``step`` on this mesh; check every leaf's block
    against the file's whole leaf; save it again under ``src``_<world>.'''
    like = tstep.abstract_train_state(cfg, dtype)
    state, _ = ckpt.restore(f"{DATA}/{src}", step, like,
                            tstep.state_shardings(like, mesh))
    params = list(state["params"].parameters())
    r = {"dtensor_params": all(isinstance(p, DTensor) and p.requires_grad
                               for p in params),
         "sharded": 0, "bad_blocks": []}
    with np.load(f"{DATA}/{src}/step-{step:08d}/arrays.npz") as z:
        for key, layer, leaf in ckpt._items(state):
            whole = z[key] if layer is None else z[key][layer]
            if not isinstance(leaf, DTensor):
                r["bad_blocks"].append((key, layer, "not a DTensor"))
                continue
            r["sharded"] += any(p.is_shard() for p in leaf.placements)
            if not np.array_equal(np_bits(leaf.to_local()),
                                  block_of(whole, leaf)):
                r["bad_blocks"].append((key, layer))
    ckpt.save(f"{DATA}/{src}_{world}", step, state)
    return r


if world == 2:
    out["c"] = restore_report("b_clean", STEPS_B, torch.bfloat16)
else:
    # (a) float32 on 4 ranks
    with recorded() as got, mock.patch.object(T, "_init_state", f32_init):
        T.train(T.RunConfig(steps=STEPS_A, ckpt_dir=f"{DATA}/a4",
                            ckpt_every=EVERY_A, **RUN))
    out["a"] = got
    # (b) bf16 with failures
    out["b"] = {}
    for fails in [(), *FAILS]:
        name = "_".join(map(str, fails)) or "clean"
        res = T.train(T.RunConfig(steps=STEPS_B, ckpt_every=EVERY_B,
                                  ckpt_dir=f"{DATA}/b_{name}",
                                  inject_failures=fails, **RUN))
        out["b"][name] = res
    # (c) the reference's checkpoint and a one-rank one on 4 ranks
    out["c"] = {"refstate": restore_report("refstate", REF_STEP,
                                           torch.bfloat16),
                "a1": restore_report("a1", STEPS_A, torch.float32)}
    # (d) from the reference's float32 weights
    out["d"] = {}
    for i, (arch, overrides) in enumerate(D_CASES):
        with open(f"{DATA}/ref_params{i}.pkl", "rb") as f:
            weights = pickle.load(f)

        def init(cfg, run, dev):
            params = lm_params_from_numpy(weights, cfg, torch.float32, "cpu")
            return {"params": params, "opt": adamw.init_state(params)}

        config = lambda name: dataclasses.replace(get_reduced_config(name),
                                                  **overrides)
        with recorded() as got, mock.patch.object(T, "_init_state", init), \
                mock.patch.object(T, "get_reduced_config", config):
            T.train(T.RunConfig(steps=STEPS_D, **dict(RUN, arch=arch)))
        out["d"][i] = got
    # (e) compression of sharded grads, then AdamW on them; then a step
    params = sh.distribute_params(
        lm_params_from_numpy(ref_params, cfg, torch.float32, "cpu"), mesh)
    p_sh = sh.param_shardings(params, mesh)
    with np.load(f"{DATA}/grads.npz") as z:
        grads = {k: sh.place(torch.from_numpy(z[k]), p_sh[k])
                 for k in z.files}
    with tstep.sharded_scope(mesh):
        q, s = compress.compress_tree(grads,
                                      compress.generator_for(0, "cpu"))
        _, opt, m = adamw.apply_updates(
            params, compress.decompress_tree(q, s), adamw.init_state(params),
            adamw.AdamWConfig())
    arrays, _ = ckpt.snapshot({"q": q, "s": s,
                               "state": {"params": params, "opt": opt}})
    if rank == 0:
        np.savez(f"{DATA}/e4.npz", **arrays)
    out["e"] = {"grad_norm": T._value(m["grad_norm"]),
                "q_placements": sorted({str(v.placements)
                                        for v in q.values()})}
    params = ref_init(cfg, None, "cpu")["params"]
    sh.distribute_params(params, mesh)
    st = {"params": params, "opt": adamw.init_state(params)}
    with np.load(f"{DATA}/batch.npz") as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    fn, _, b_sh = tstep.build_train_step(
        cfg, mesh, tstep.TrainConfig(grad_compress=True, microbatches=2),
        abstract_state=st, abstract_batch=batch)
    _, m = fn(st, sh.place_tree(batch, b_sh))
    out["e"]["step"] = [T._value(m["total_loss"]),
                        T._value(m["grad_norm"])]
    # (f) main() in this started group
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        T.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "2",
                "--global-batch", "4", "--seq-len", "16", "--device", "cpu"])
    out["f"] = {"lines": buf.getvalue().splitlines(),
                "group_kept": dist.is_initialized()}
with open(f"{DATA}/rank{rank}_of_{world}.pkl", "wb") as f:
    pickle.dump(out, f)
"""

_REFERENCE = """
import dataclasses, json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.launch import train as JT
from repro.train import step as jstep

tmp, cases = sys.argv[1], json.loads(sys.argv[2])
build = JT.build_train_step
out = {}
for i, (arch, overrides) in enumerate(cases):
    with open(f"{tmp}/ref_params{i}.pkl", "rb") as f:
        want = pickle.load(f)

    def init(cfg, key):
        state = jstep.init_train_state(cfg, key, jnp.float32)
        for a, b in zip(jax.tree.leaves(state["params"]),
                        jax.tree.leaves(want)):
            assert np.array_equal(np.asarray(a), b)
        return state

    got = []

    def wrapped(*a, **k):
        fn, st_sh, b_sh = build(*a, **k)

        def step(state, batch):
            state, m = fn(state, batch)
            got.append([float(m["total_loss"]), float(m["grad_norm"])])
            return state, m
        return step, st_sh, b_sh

    JT.init_train_state, JT.build_train_step = init, wrapped
    JT.get_reduced_config = lambda name: dataclasses.replace(
        get_reduced_config(name), **overrides)
    JT.train(JT.RunConfig(arch=arch, reduced=True, steps=STEPS_D,
                          global_batch=4, seq_len=16, microbatches=2))
    out[i] = got
out["mesh"] = list(JT.make_test_mesh().devices.shape)
with open(f"{tmp}/ref_d.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def f32_close(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= 1e-4 + 1e-4 * abs(want), (what, got, want)


def norm_close(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= 1e-4 * want, (what, got, want)


def batch_numpy(seed: int) -> dict:
    cfg = get_reduced_config(ARCH)
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
            for k in ("tokens", "labels")}


def one_rank_compress(ref_params: dict, grads: dict) -> tuple[dict, list]:
    """(e) on one rank: (arrays as snapshot gives them, [loss, grad_norm]
    of one compressed train step)."""
    cfg = get_reduced_config(ARCH)
    T, tstep = SHARED["T"], SHARED["tstep"]
    params = lm_params_from_numpy(ref_params, cfg, torch.float32, "cpu")
    q, s = compress.compress_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        compress.generator_for(0, "cpu"))
    _, opt, _ = adamw.apply_updates(params, compress.decompress_tree(q, s),
                                    adamw.init_state(params),
                                    adamw.AdamWConfig())
    arrays, _ = ckpt.snapshot({"q": q, "s": s,
                               "state": {"params": params, "opt": opt}})
    params = lm_params_from_numpy(ref_params, cfg, torch.float32, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_numpy(5).items()}
    fn, _, _ = tstep.build_train_step(
        cfg, make_test_mesh(device="cpu"),
        tstep.TrainConfig(grad_compress=True, microbatches=2))
    _, m = fn({"params": params, "opt": adamw.init_state(params)}, batch)
    return arrays, [T._value(m["total_loss"]), T._value(m["grad_norm"])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything every test below reads: the one-rank runs here, the
    reference's driver in a subprocess meanwhile, then the 4-rank and the
    2-rank groups."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    for i, (arch, overrides) in enumerate(D_CASES):
        jcfg = dataclasses.replace(j_get_reduced(arch), **overrides)
        jparams = jstep.init_train_state(jcfg, jax.random.key(0),
                                         jnp.float32)["params"]
        with open(tmp / f"ref_params{i}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     jparams), f)
    with open(tmp / "ref_params0.pkl", "rb") as f:
        ref_params = pickle.load(f)
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE.replace("STEPS_D", str(STEPS_D)),
         str(tmp), json.dumps(D_CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = {"ref_params": ref_params}
        jckpt.save(str(tmp / "refstate"), REF_STEP, reference_state(ARCH))
        T = SHARED["T"]
        with SHARED["recorded"]() as got, \
                SHARED["mock"].patch.object(T, "_init_state",
                                            SHARED["f32_init"]):
            T.train(T.RunConfig(steps=STEPS_A, ckpt_dir=str(tmp / "a1"),
                                ckpt_every=EVERY_A, **SHARED["RUN"]))
        out["a1"] = got
        rng = np.random.default_rng(11)
        cfg = get_reduced_config(ARCH)
        grads = {k: (rng.standard_normal(tuple(p.shape)) * GRAD_SCALE
                     ).astype(np.float32)
                 for k, p in SHARED["tstep"].abstract_params(
                     cfg, torch.float32).named_parameters()}
        np.savez(tmp / "grads.npz", **grads)
        np.savez(tmp / "batch.npz", **batch_numpy(5))
        out["e1"], out["e1_step"] = one_rank_compress(ref_params, grads)
        body = (_RANKS.replace("SHARED", _SHARED)
                .replace("DATA_DIR", str(tmp))
                .replace("STEPS_A", str(STEPS_A))
                .replace("EVERY_A", str(EVERY_A))
                .replace("STEPS_B", str(STEPS_B))
                .replace("EVERY_B", str(EVERY_B))
                .replace("FAILS", repr(FAILS))
                .replace("REF_STEP", str(REF_STEP))
                .replace("STEPS_D", str(STEPS_D))
                .replace("D_CASES", repr(D_CASES)))
        for world in (4, 2):            # a file store of each group's own
            os.makedirs(tmp / f"group{world}")
            run_ranks(body, world, tmp / f"group{world}", timeout=TIMEOUT)
        ref_out, ref_err = ref.communicate(timeout=TIMEOUT)
        assert ref.returncode == 0, ref_err[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    for world in (4, 2):
        out[world] = []
        for r in range(world):
            with open(tmp / f"rank{r}_of_{world}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    with open(tmp / "ref_d.pkl", "rb") as f:
        out["ref_d"] = pickle.load(f)
    out["tmp"] = tmp
    return out


def by_step(log: list) -> dict:
    first = {}
    for r in log:
        first.setdefault(r["step"], r)
    return first


def test_mesh_is_the_references(runs):
    assert runs[4][0]["mesh"] == runs["ref_d"]["mesh"] == [1, 1, 4]
    assert runs[2][0]["mesh"] == [1, 1, 2]


def test_a_four_ranks_train_as_one(runs):
    """(a) float32: the 4-rank driver's losses and grad norms are the
    one-rank driver's, and both checkpoints have one layout."""
    want = runs["a1"]
    assert len(want) == STEPS_A
    for r in range(4):
        got = runs[4][r]["a"]
        assert len(got) == STEPS_A
        for s, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
            f32_close(gl, wl, f"rank {r} loss at {s}")
            norm_close(gn, wn, f"rank {r} grad_norm at {s}")
    for step in range(EVERY_A, STEPS_A + 1, EVERY_A):
        one, m1 = bits(str(runs["tmp"] / "a1" / f"step-{step:08d}"))
        four, m4 = bits(str(runs["tmp"] / "a4" / f"step-{step:08d}"))
        assert m1 == m4
        assert {k: (v.dtype, v.shape) for k, v in one.items()} == {
            k: (v.dtype, v.shape) for k, v in four.items()}


@pytest.mark.parametrize("fails", FAILS, ids=str)
def test_b_replays_to_the_clean_state(runs, fails):
    """(b) bf16 on 4 ranks: failures after a checkpoint, before the first
    and twice end in the clean run's final checkpoint, bit for bit; the
    replayed steps log what the first pass logged."""
    name = "_".join(map(str, fails))
    tmp = runs["tmp"]
    final = f"step-{STEPS_B:08d}"
    clean, _ = bits(str(tmp / "b_clean" / final))
    faulty, _ = bits(str(tmp / f"b_{name}" / final))
    same_bits(clean, faulty)
    out0, out1 = runs[4][0]["b"]["clean"], runs[4][0]["b"][name]
    assert out0["restarts"] == 0 and out1["restarts"] == len(fails)
    assert out0["steps"] == out1["steps"] == STEPS_B
    first = by_step(out0["log"])
    assert len(out1["log"]) > len(out0["log"])
    for r in out1["log"]:
        want = first[r["step"]]
        assert (r["loss"], r["grad_norm"]) == (want["loss"],
                                               want["grad_norm"])


def test_b_every_rank_returns_the_same(runs):
    """Every rank takes the same path and logs the same values; only the
    seconds are each rank's own."""
    keep = ("step", "loss", "grad_norm")
    for name, want in runs[4][0]["b"].items():
        for r in range(1, 4):
            got = runs[4][r]["b"][name]
            assert got["restarts"] == want["restarts"], (name, r)
            assert got["steps"] == want["steps"], (name, r)
            assert [[x[k] for k in keep] for x in got["log"]] == [
                [x[k] for k in keep] for x in want["log"]], (name, r)


def test_c_four_rank_checkpoint_restores_anywhere(runs):
    """(c) the 4-rank final checkpoint on 1 rank, on 2 ranks and in the
    reference: the same bits each time."""
    tmp = runs["tmp"]
    want, manifest = bits(str(tmp / "b_clean" / f"step-{STEPS_B:08d}"))
    cfg = get_reduced_config(ARCH)
    tstep = SHARED["tstep"]
    like = tstep.abstract_train_state(cfg)
    state, _ = ckpt.restore(str(tmp / "b_clean"), STEPS_B, like,
                            tstep.state_shardings(like,
                                                  make_test_mesh(device="cpu")))
    same_bits(ckpt.snapshot(state)[0], want)
    for r in range(2):
        rep = runs[2][r]["c"]
        assert rep["dtensor_params"] and not rep["bad_blocks"], rep
        assert rep["sharded"] > 0
    same_bits(bits(str(tmp / "b_clean_2" / f"step-{STEPS_B:08d}"))[0], want)
    tree, jmanifest = jckpt.restore(str(tmp / "b_clean"), STEPS_B,
                                    jstep.abstract_train_state(
                                        j_get_reduced(ARCH)))
    assert jmanifest == manifest
    keys, leaves, _ = jckpt._paths(tree)
    assert sorted(keys) == sorted(want)
    for k, leaf in zip(keys, leaves):
        assert np.array_equal(jckpt._encode(np.asarray(leaf)), want[k]), k


@pytest.mark.parametrize("src,step", [("refstate", REF_STEP),
                                      ("a1", STEPS_A)],
                         ids=["reference", "one_rank"])
def test_c_restores_on_four_ranks(runs, src, step):
    """(c) the reference's bf16 checkpoint and the one-rank driver's
    float32 one on 4 ranks: every parameter a DTensor, every block the
    whole leaf's slice; saved again from 4 ranks, the same content."""
    for r in range(4):
        rep = runs[4][r]["c"][src]
        assert rep["dtensor_params"] and not rep["bad_blocks"], (r, rep)
        assert rep["sharded"] > 0
    tmp = runs["tmp"]
    want, manifest = bits(str(tmp / src / f"step-{step:08d}"))
    got, manifest4 = bits(str(tmp / f"{src}_4" / f"step-{step:08d}"))
    same_bits(got, want)
    assert manifest4["dtypes"] == manifest["dtypes"]


@pytest.mark.parametrize("i", range(len(D_CASES)),
                         ids=[a + ("-" + o["moe_dispatch"] if o else "")
                              for a, o in D_CASES])
def test_d_matches_the_reference_driver(runs, i):
    """(d) the port's 4-rank driver and the reference's on 4 host
    devices, from the same float32 weights."""
    want = runs["ref_d"][i]
    assert len(want) == STEPS_D
    for r in range(4):
        got = runs[4][r]["d"][i]
        assert len(got) == STEPS_D
        for s, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
            f32_close(gl, wl, f"rank {r} loss at {s}")
            f32_close(gn, wn, f"rank {r} grad_norm at {s}")


def test_e_sharded_compression_is_one_ranks(runs):
    """(e) q, the scales and the state after AdamW on the dequantized
    grads: 4 ranks equal one, bit for bit."""
    with np.load(runs["tmp"] / "e4.npz") as z:
        got = {k: z[k] for k in z.files}
    same_bits(got, runs["e1"])
    assert any(k.startswith("q/") for k in got)
    assert runs[4][0]["e"]["grad_norm"] < 1.0      # no clip: scale 1
    assert any("Shard" in p for p in runs[4][0]["e"]["q_placements"])


def test_e_compressed_sharded_step(runs):
    wl, wn = runs["e1_step"]
    for r in range(4):
        gl, gn = runs[4][r]["e"]["step"]
        f32_close(gl, wl, f"rank {r} loss")
        norm_close(gn, wn, f"rank {r} grad_norm")


def test_f_main_prints_on_rank0_only(runs):
    lines = runs[4][0]["f"]["lines"]
    assert [set(json.loads(x)) for x in lines[:2]] == [
        {"step", "loss", "grad_norm", "sec", "straggler"}] * 2
    assert len(lines) == 3
    assert set(json.loads(lines[-1])) == {"final_loss", "first_loss",
                                          "restarts", "straggler_flags",
                                          "steps"}
    for r in range(4):
        assert runs[4][r]["f"]["group_kept"]
        if r:
            assert runs[4][r]["f"]["lines"] == []


def test_f_torchrun_starts_and_ends_its_group():
    """``python -m torch.distributed.run`` over 2 CPU ranks: ``main()``
    starts the group from torchrun's variables; one JSON line a step and
    the summary, from rank 0 alone."""
    env = dict(_rank_env())
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--reduced", "--steps", "2", "--global-batch", "4",
         "--seq-len", "16", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3, r.stdout
    assert [json.loads(x)["step"] for x in lines[:2]] == [0, 1]
    assert json.loads(lines[-1])["steps"] == 2
