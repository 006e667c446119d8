"""The LM's steps sharded over a (pod 1, data 2, model 2) mesh of 4 gloo
ranks against the reference, on the CPU.

Each rank holds the reference's float32 ``init_params`` (carried across
with ``interop.lm_params_from_numpy``) distributed by the reference's
specs (``launch.shardings.distribute_params``), its batch and caches
placed likewise, and runs: the train step's gradient accumulation over 2
microbatches (the loss and every grad, ``full_tensor()``), one whole
train step (its ``loss`` and ``grad_norm``), prefill logits and two
``serve_step`` positions on seeded caches.  The reference's values are
its unsharded ``jax.value_and_grad`` of ``loss_fn`` on the same two
microbatches (rows [0, 2) and [2, 4): the mean of their losses and
grads, as its microbatch scan computes), ``prefill_step`` and
``serve_step``.  The ``ep`` dispatch is the one exception: it is defined
by its mesh (each data shard chunks and routes its own tokens), so its
reference runs under the reference's own (1, 2, 2) mesh of 4 host
devices, the batch split by ``batch_shardings``.

Tolerance (float32, as ``test_torch_models.py``): |got - want| <= 1e-4 +
1e-4·|want| element by element; ``grad_norm`` within 1e-4 of it,
relatively.  On one rank (``LocalMesh``) the steps must give, bit for
bit, what the unsharded functions give.
"""
import dataclasses
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import LocalMesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_dispatcher import run_ranks, run_reference  # noqa: E402

CASES = [("llama3.2-3b", {}),
         ("qwen3-moe-30b-a3b", {"moe_dispatch": "ep"}),
         ("qwen3-moe-30b-a3b", {"moe_dispatch": "gather"}),
         ("mamba2-370m", {}),
         ("recurrentgemma-2b", {}),
         ("whisper-small", {}),
         ("llava-next-34b", {})]
IDS = [n + ("-" + o["moe_dispatch"] if o else "") for n, o in CASES]
B, S, ENC, CACHE = 4, 16, 8, 8
MICRO = 2
POSITIONS = 2
TIMEOUT = 900


def f32_close(got, want, what: str) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - (1e-4 + 1e-4 * np.abs(want))
    assert (excess <= 0).all(), (what, float(excess.max()),
                                 float(np.abs(got - want).max()))


def inputs(cfg, seed: int) -> dict:
    """Seeded numpy batch, decode caches' values and decode tokens."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal((B, ENC, cfg.d_model),
                                              dtype=np.float32)
    caches = tt.init_decode_state(cfg, B, CACHE, torch.float32,
                                  enc_len=ENC if cfg.encoder_layers else 0,
                                  device="cpu")
    caches = [{k: rng.standard_normal(tuple(v.shape), dtype=np.float32)
               * 0.5 for k, v in c.items()} for c in caches]
    tokens = rng.integers(0, cfg.vocab_size, (POSITIONS, B), dtype=np.int32)
    return {"batch": batch, "caches": caches, "tokens": tokens}


_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import make_mesh, use_mesh
from repro.configs import get_reduced_config
from repro.launch import shardings as jsh
from repro.models import transformer as jt

tmp, n = sys.argv[1], int(sys.argv[2])
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
for i in range(n):
    with open(f"{tmp}/case{i}.pkl", "rb") as f:
        case = pickle.load(f)
    cfg = dataclasses.replace(get_reduced_config(case["name"]),
                              **case["overrides"])
    params = jax.jit(lambda k: jt.init_params(cfg, k, jnp.float32))(
        jax.random.key(0))
    mesh = None
    if cfg.moe_dispatch == "ep":
        mesh = make_mesh((1, 2, 2), ("pod", "data", "model"))

    def jit(fn, args):
        if mesh is None:
            return jax.jit(fn)
        shard = [jsh.param_shardings(args[0], mesh)] + [None] * (len(args)
                                                               - 1)
        if len(args) > 1 and isinstance(args[1], dict):
            shard[1] = jsh.batch_shardings(args[1], mesh)
        def inner(*a):
            with use_mesh(mesh):
                return fn(*a)
        return jax.jit(inner, in_shardings=tuple(shard))

    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    vg = jax.value_and_grad(lambda p, b: jt.loss_fn(p, cfg, b),
                            has_aux=True)
    m = batch["labels"].shape[0] // case["micro"]
    losses, grads = [], None
    for j in range(case["micro"]):
        mb = {k: v[j * m:(j + 1) * m] for k, v in batch.items()}
        (loss, _), g = jit(vg, (params, mb))(params, mb)
        losses.append(float(loss))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda g: g / case["micro"], grads)
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree.leaves(grads))))
    pb = {k: v for k, v in batch.items() if k != "labels"}
    prefill = jit(lambda p, b: jt.prefill_step(p, cfg, b), (params, pb))(
        params, pb)
    caches = jax.tree.map(jnp.asarray, case["caches"])
    step = jit(lambda p, c, t, pos: jt.serve_step(p, cfg, c, t, pos),
               (params, caches, None, None))
    serve = []
    for pos in range(case["tokens"].shape[0]):
        logits, caches = step(params, caches, jnp.asarray(case["tokens"][pos]),
                              jnp.int32(pos))
        serve.append(np.asarray(logits, np.float32))
    with open(f"{tmp}/ref{i}.pkl", "wb") as f:
        pickle.dump({"params": f32(params), "loss": float(np.mean(losses)),
                     "grads": f32(grads), "grad_norm": norm,
                     "prefill": np.asarray(prefill, np.float32),
                     "serve": serve}, f)
"""

_RANKS = """
import dataclasses, pickle
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_reduced_config
from repro_torch.interop import decode_state_from_numpy, lm_params_from_numpy
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import step as tstep

mesh = make_mesh((1, 2, 2), ("pod", "data", "model"), device="cpu")
full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t
                  ).detach().numpy()
for i in range(N_CASES):
    with open(f"{tmp}/case{i}.pkl", "rb") as f:
        case = pickle.load(f)
    with open(f"{tmp}/ref{i}.pkl", "rb") as f:
        tree = pickle.load(f)["params"]
    cfg = dataclasses.replace(get_reduced_config(case["name"]),
                              **case["overrides"])
    params = lm_params_from_numpy(tree, cfg, torch.float32, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    sh.distribute_params(params, mesh)
    placed = sh.place_tree(batch, sh.batch_shardings(batch, mesh))
    with tstep.sharded_scope(mesh):
        loss, _, grads = tstep.accumulate_grads(params, cfg, placed,
                                                case["micro"])
    out = {"loss": float(full(loss)),
           "grads": {k: full(g) for k, g in grads.items()}}
    del grads
    pb = {k: v for k, v in batch.items() if k != "labels"}
    fn, _, b_sh = tstep.build_prefill_step(cfg, mesh, abstract_batch=pb)
    out["prefill"] = full(fn(params, sh.place_tree(pb, b_sh)))
    caches = decode_state_from_numpy(case["caches"], torch.float32, "cpu")
    fn, _, c_sh = tstep.build_serve_step(cfg, mesh, abstract_caches=caches)
    caches = sh.place_tree(caches, c_sh)
    tok_sh = sh.batch_shardings({"t": torch.zeros(case["tokens"].shape[1])},
                                mesh)["t"]
    out["serve"] = []
    for pos in range(case["tokens"].shape[0]):
        tok = sh.place(torch.from_numpy(case["tokens"][pos]), tok_sh)
        logits, caches = fn(params, caches, tok, pos)
        out["serve"].append(full(logits))
    state = {"params": params, "opt": sh.place_tree(
        tstep.adamw.init_state(params),
        tstep.state_shardings({"params": params,
                               "opt": tstep.adamw.init_state(params)},
                              mesh)["opt"])}
    fn, _, _ = tstep.build_train_step(
        cfg, mesh, tstep.TrainConfig(microbatches=case["micro"]),
        abstract_state=state)
    _, metrics = fn(state, placed)
    out["step"] = {k: float(full(v)) for k, v in metrics.items()}
    if rank == 0:
        with open(f"{tmp}/got{i}.pkl", "wb") as f:
            pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port) results of every case: the reference in one
    subprocess of 4 host devices, the port on 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("lm_sharded")
    for i, (name, overrides) in enumerate(CASES):
        cfg = dataclasses.replace(get_reduced_config(name), **overrides)
        case = dict(inputs(cfg, seed=10 + i), name=name,
                    overrides=overrides, micro=MICRO)
        with open(tmp / f"case{i}.pkl", "wb") as f:
            pickle.dump(case, f)
    run_reference(_REFERENCE, 4, str(tmp), str(len(CASES)), timeout=TIMEOUT)
    run_ranks(_RANKS.replace("N_CASES", str(len(CASES))), 4, tmp,
              timeout=TIMEOUT)
    out = []
    for i in range(len(CASES)):
        with open(tmp / f"ref{i}.pkl", "rb") as f:
            ref = pickle.load(f)
        with open(tmp / f"got{i}.pkl", "rb") as f:
            out.append((ref, pickle.load(f)))
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_train_grads_match_reference(results, i):
    ref, got = results[i]
    cfg = dataclasses.replace(get_reduced_config(CASES[i][0]), **CASES[i][1])
    f32_close(got["loss"], ref["loss"], "loss")
    want = {}
    for name, p in tt.abstract_params(cfg, torch.float32).named_parameters():
        path, layer = tt.reference_path(name)
        leaf = ref["grads"]
        for k in path:
            leaf = leaf[int(k[1:-1])] if k.startswith("[") else leaf[k]
        want[name] = leaf if layer is None else leaf[layer]
    assert set(got["grads"]) == set(want)
    for name, w in want.items():
        f32_close(got["grads"][name], w, f"grad {name}")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_train_step_metrics(results, i):
    ref, got = results[i]
    f32_close(got["step"]["total_loss"], ref["loss"], "total_loss")
    gn, want = got["step"]["grad_norm"], ref["grad_norm"]
    assert abs(gn - want) <= 1e-4 * want, (gn, want)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_prefill_and_serve_match_reference(results, i):
    ref, got = results[i]
    f32_close(got["prefill"], ref["prefill"], "prefill logits")
    assert len(got["serve"]) == POSITIONS
    for pos, (g, w) in enumerate(zip(got["serve"], ref["serve"])):
        f32_close(g, w, f"serve logits at {pos}")


def test_one_rank_steps_are_unchanged():
    """On a ``LocalMesh`` placing gives plain tensors and every step gives
    bit for bit what the unsharded functions give."""
    cfg = get_reduced_config("llama3.2-3b")
    mesh = LocalMesh(device="cpu")
    data = inputs(cfg, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].items()}

    def fresh():
        g = torch.Generator().manual_seed(0)
        return tt.init_params(cfg, g, torch.float32)

    params = sh.distribute_params(fresh(), mesh)
    assert not any(isinstance(p.data, torch.distributed.tensor.DTensor)
                   for p in params.parameters())
    placed = sh.place_tree(batch, sh.batch_shardings(batch, mesh))
    fn, _, _ = tstep.build_prefill_step(cfg, mesh)
    plain = fresh()
    with torch.no_grad():
        want = tt.prefill_step(plain, cfg, {"tokens": batch["tokens"]})
    assert torch.equal(fn(params, {"tokens": placed["tokens"]}), want)
    fn, _, _ = tstep.build_train_step(
        cfg, mesh, tstep.TrainConfig(microbatches=MICRO),
        abstract_state={"params": params,
                        "opt": adamw.init_state(params)})
    st, m = fn({"params": params, "opt": adamw.init_state(params)}, placed)
    st2, m2 = tstep.train_step_fn(
        cfg, tstep.TrainConfig(microbatches=MICRO),
        {"params": plain, "opt": adamw.init_state(plain)}, batch)
    for k in m:
        assert torch.equal(m[k], m2[k]), k
    for (k, a), (_, b) in zip(st["params"].named_parameters(),
                              st2["params"].named_parameters()):
        assert torch.equal(a, b), k
