"""The port's training path (``repro_torch.optim``, ``repro_torch.train``)
against the reference's (``repro.optim``, ``repro.train``) on the CPU.

Weights are the reference's ``init_params(cfg, jax.random.key(0),
float32)`` carried across with ``interop.lm_params_from_numpy``; data is
``make_batch``'s seeded numpy; grads for the optimizer cases are seeded
numpy.  Tolerances (float32), and why:

- loss, aux, total_loss: |got - want| <= 1e-4 + 1e-4·|want| (the forward
  pass's bound, ``test_torch_models.py``); grad_norm within 1e-4 of it,
  relatively; lr within 1e-6, relatively (one float32 schedule);
- ``m`` and ``v`` after the steps: max |got - want| <= 1e-3·max |want|
  for each leaf (sums of grads whose reductions run in another order);
- parameters after k train steps: |got - want| <= 2·(lr_1 + ... + lr_k):
  AdamW's normalised step ``m̂ / (sqrt(v̂) + eps)`` is about ±1 an
  element and flips sign where g ≈ 0, so an element may land up to
  2·lr a step away;
- ``apply_updates`` on the same grads: the global norm within 1e-5,
  relatively (float32 sums of up to 10^5 squares in another order),
  parameters, ``m`` and ``v`` within 1e-5·max|want| a leaf (the clip
  scale carries the norm's error), bf16 parameters within one bf16 ulp
  of the reference's;
- remat on against off: bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.ckpt.checkpoint import _paths as j_paths  # noqa: E402
from repro.configs import get_reduced_config as j_get_reduced  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.launch.mesh import make_test_mesh as j_make_test_mesh  # noqa: E402
from repro.launch.train import RunConfig as JRunConfig  # noqa: E402
from repro.launch.train import data_config as j_data_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.ckpt.checkpoint import snapshot  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_reduced_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.transformer import reference_path  # noqa: E402
from repro_torch.launch.train import RunConfig, data_config  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import compress  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CPU = "cpu"
BATCH, SEQ = 2, 16
STEPS = 2


def loss_close(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= 1e-4 + 1e-4 * abs(want), (what, got, want)


def leaves_close(got: dict, want: dict, rel: float, what: str):
    """Every leaf (key -> array) within rel·max|want| of the reference's."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()) + 1e-30, (what, k, err)


def reference_arrays(tree) -> dict:
    """The reference's leaves as f32 numpy, keyed by its checkpoint paths."""
    keys, leaves, _ = j_paths(tree)
    return {k: np.asarray(v, np.float32) for k, v in zip(keys, leaves)}


def port_arrays(tree) -> dict:
    """The port's leaves in the reference's layout, as f32 numpy."""
    arrays, dtypes = snapshot(tree)
    return {k: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                .float().numpy() if dtypes[k] == "bfloat16"
                else np.asarray(a, np.float32)) for k, a in arrays.items()}


@functools.lru_cache(maxsize=None)
def reference_init(name: str, dtype=jnp.float32):
    cfg = j_get_reduced(name)
    return jax.jit(lambda k: jt.init_params(cfg, k, dtype))(
        jax.random.key(0))


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def run_reference(name: str, cfg, microbatches: int = 1, steps: int = STEPS):
    """``steps`` steps of the reference's ``build_train_step`` on
    ``make_test_mesh()`` from the float32 init; (state, metrics a step)."""
    # a copy: the step donates its state
    params = jax.tree.map(jnp.array, reference_init(name))
    state = {"params": params, "opt": jadamw.init_state(params)}
    ab = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                      state)
    fn, _, _ = jstep.build_train_step(
        cfg, j_make_test_mesh(),
        tcfg=jstep.TrainConfig(microbatches=microbatches), abstract_state=ab)
    dcfg = j_data_config(cfg, JRunConfig(arch=name, global_batch=BATCH,
                                         seq_len=SEQ))
    metrics = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in j_make_batch(dcfg, s).items()}
        state, m = fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def run_port(name: str, cfg, microbatches: int = 1, steps: int = STEPS,
             grad_compress: bool = False):
    params = lm_params_from_numpy(f32_tree(reference_init(name)), cfg,
                                  torch.float32, CPU)
    state = {"params": params, "opt": adamw.init_state(params)}
    fn, _, _ = tstep.build_train_step(
        cfg, make_test_mesh(device=CPU),
        tcfg=tstep.TrainConfig(microbatches=microbatches,
                               grad_compress=grad_compress),
        abstract_state=tstep.abstract_train_state(cfg, torch.float32))
    dcfg = data_config(cfg, RunConfig(arch=name, global_batch=BATCH,
                                      seq_len=SEQ, device=CPU))
    metrics = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in
                 make_batch(dcfg, s).items()}
        state, m = fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def check_train_step(name: str, microbatches: int = 1):
    """``STEPS`` port train steps against the reference's, float32."""
    jcfg, cfg = j_get_reduced(name), get_reduced_config(name)
    jstate, jm = run_reference(name, jcfg, microbatches)
    state, m = run_port(name, cfg, microbatches)
    lr_sum = 0.0
    for got, want in zip(m, jm):
        assert set(got) == set(want) == {"loss", "aux", "grad_norm", "lr",
                                         "total_loss"}
        for k in ("loss", "aux", "total_loss"):
            loss_close(got[k], want[k], (name, k))
        assert abs(got["grad_norm"] - want["grad_norm"]) <= (
            1e-4 * want["grad_norm"]), (name, got, want)
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        lr_sum += want["lr"]
    want = reference_arrays(jstate)
    got = port_arrays(state)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("params/"):
            err = float(np.abs(got[k] - w).max())
            assert err <= 2 * lr_sum, (name, k, err, lr_sum)
    for part in ("opt/m/", "opt/v/"):
        leaves_close({k: v for k, v in got.items() if k.startswith(part)},
                     {k: v for k, v in want.items() if k.startswith(part)},
                     1e-3, (name, part))
    assert int(got["opt/step"]) == int(want["opt/step"]) == STEPS


# -- AdamW ------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    jadamw.AdamWConfig(),
    jadamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50,
                       min_lr_frac=0.0),
    jadamw.AdamWConfig(warmup_steps=10, total_steps=10)])
def test_schedule_matches_reference(cfg):
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.array([0, 1, 5, 10, 11, 25, 99, 100, 101, 5000, 9999, 10000,
                      20000], np.int32)
    want = np.asarray(jadamw.schedule(cfg, jnp.asarray(steps)))
    got = adamw.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decay_mask_matches_reference(name):
    """Every parameter's decay flag is the reference's for its leaf."""
    from jax.tree_util import tree_flatten_with_path
    abstract = jax.eval_shape(functools.partial(
        jt.init_params, j_get_reduced(name)), jax.random.key(0))
    want = {}
    for path, _ in tree_flatten_with_path(abstract)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        want[key] = jadamw._decay_mask(path)
    got = {}
    for pname, _ in tt.abstract_params(get_reduced_config(name)
                                       ).named_parameters():
        key = "/".join(reference_path(pname)[0])
        flag = adamw._decay_mask(pname)
        assert got.setdefault(key, flag) == flag
    assert got == want
    assert not all(want.values()) and any(want.values())


def _random_like(tree, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                   ).astype(np.float32), tree)


@pytest.mark.parametrize("name,dtype", [("llama3.2-3b", "float32"),
                                        ("mamba2-370m", "bfloat16")])
@pytest.mark.parametrize("gscale", [1e-3, 1.0])   # unclipped, clipped
def test_apply_updates_matches_reference(name, dtype, gscale):
    """Three AdamW updates from the same params and grads: the same
    parameters, m, v, grad_norm and lr."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    cfg = get_reduced_config(name)
    params = reference_init(name, jdt)
    grads = [_random_like(f32_tree(params), s, gscale) for s in range(3)]
    ocfg = jadamw.AdamWConfig(warmup_steps=1, weight_decay=0.5)
    state = jadamw.init_state(params)
    upd = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, ocfg))
    tparams = lm_params_from_numpy(f32_tree(params), cfg, tdt, CPU)
    tstate = adamw.init_state(tparams)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(ocfg))
    for g in grads:
        jg = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, params)
        params, state, jm = upd(params, jg, state)
        tg = {k: p.detach() for k, p in lm_params_from_numpy(
            f32_tree(jg), cfg, tdt, CPU).named_parameters()}
        tparams, tstate, m = adamw.apply_updates(tparams, tg, tstate, tcfg)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-5 * float(jm["grad_norm"]))
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = reference_arrays({"params": params, "opt": state})
    got = port_arrays({"params": tparams, "opt": tstate})
    for part in ("opt/m/", "opt/v/"):
        leaves_close({k: v for k, v in got.items() if k.startswith(part)},
                     {k: v for k, v in want.items() if k.startswith(part)},
                     1e-5, part)
    for k, w in want.items():
        if not k.startswith("params/"):
            continue
        if dtype == "float32":
            leaves_close({k: got[k]}, {k: w}, 1e-5, k)
        else:    # one bf16 ulp: 2^-7 of the value's binade
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert (np.abs(got[k] - w) <= ulp).all(), k
    assert int(tstate["step"]) == int(state["step"]) == 3


def test_apply_updates_updates_in_place():
    cfg = get_reduced_config("llama3.2-3b")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    state = adamw.init_state(params)
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    grads = {k: torch.ones_like(p) for k, p in params.named_parameters()}
    ptrs = {k: p.data_ptr() for k, p in params.named_parameters()}
    out, new_state, _ = adamw.apply_updates(params, grads, state,
                                            adamw.AdamWConfig())
    assert out is params and new_state["m"] is state["m"]
    for k, p in params.named_parameters():
        assert p.data_ptr() == ptrs[k] and not torch.equal(p, before[k])
    assert int(new_state["step"]) == 1 and int(state["step"]) == 0


# -- gradient compression (held by its contract: JAX's key stream has no
# torch counterpart) ----------------------------------------------------------

def test_compress_contract():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 33)).astype(np.float32)) * 3.0
    q, scale = compress.quantize(g, compress.generator_for(5, CPU))
    assert q.dtype == torch.int8
    assert int(q.abs().max()) <= 127
    assert float(scale) == pytest.approx(float(g.abs().max()) / 127.0,
                                         rel=1e-6)
    err = compress.dequantize(q, scale) - g
    assert float(err.abs().max()) <= float(scale) * (1 + 1e-6)
    q2, s2 = compress.quantize(g, compress.generator_for(5, CPU))
    assert torch.equal(q, q2) and torch.equal(scale, s2)
    q3, _ = compress.quantize(g, compress.generator_for(6, CPU))
    assert not torch.equal(q, q3)


def test_compress_is_unbiased():
    """Stochastic rounding: the mean error over many draws shrinks as
    1/sqrt(draws) (here under 0.05 of a scale an element, 10 sigma)."""
    g = torch.linspace(-1.0, 1.0, 257)
    gen = compress.generator_for(0, CPU)
    draws = 4000
    acc = torch.zeros_like(g)
    for _ in range(draws):
        q, scale = compress.quantize(g, gen)
        acc += compress.dequantize(q, scale) - g
    assert float((acc / draws).abs().max()) <= 0.05 * float(scale)


def test_compress_exact_on_the_grid():
    """Where g / scale is an integer the round trip is exact."""
    ints = torch.arange(-127, 128, dtype=torch.float32)
    scale = 0.125
    g = ints * scale
    qt, st = compress.compress_tree({"a": g, "b": g[::3]},
                                    compress.generator_for(1, CPU))
    back = compress.decompress_tree(qt, st)
    assert torch.equal(back["a"], g) and torch.equal(back["b"], g[::3])


def test_grad_compress_step_is_seeded():
    """``grad_compress`` draws its noise from (0, step): two runs give the
    same state, within 2·sum(lr) of the uncompressed run's params."""
    name = "llama3.2-3b"
    cfg = get_reduced_config(name)
    runs = [run_port(name, cfg, grad_compress=c) for c in (True, True,
                                                             False)]
    a, b, plain = (port_arrays(s) for s, _ in runs)
    lr_sum = sum(m["lr"] for m in runs[2][1])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
        if k.startswith("params/"):
            assert float(np.abs(a[k] - plain[k]).max()) <= 2 * lr_sum, k


# -- the train step -----------------------------------------------------------

def test_microbatches_match_reference():
    check_train_step("llama3.2-3b", microbatches=2)


def test_microbatches_sum_grads_in_float32():
    """With microbatches the grads are f32 sums over the parts: the same
    step as one batch (within the f32 bound), for bf16 weights too."""
    cfg = get_reduced_config("llama3.2-3b")
    for dtype in (torch.float32, torch.bfloat16):
        states = []
        for nm in (1, 2):
            params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                                    dtype)
            state = {"params": params, "opt": adamw.init_state(params)}
            rng = np.random.default_rng(0)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (4, SEQ), dtype=np.int32))
                for k in ("tokens", "labels")}
            state, m = tstep.train_step_fn(
                cfg, tstep.TrainConfig(microbatches=nm), state, batch)
            states.append((state, m))
        (s1, m1), (s2, m2) = states
        bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
        assert abs(float(m1["total_loss"]) - float(m2["total_loss"])) <= (
            bound * float(m1["total_loss"]))
        assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= (
            10 * bound * float(m1["grad_norm"]))


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m", "whisper-small",
                                  "recurrentgemma-2b", "gemma3-4b"])
def test_remat_on_equals_off(name):
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    loss and the same grads, bit for bit."""
    base = get_reduced_config(name)
    assert base.remat
    rng = np.random.default_rng(1)
    batch = {"labels": rng.integers(0, base.vocab_size, (BATCH, SEQ),
                                    dtype=np.int32)}
    if base.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal((BATCH, SEQ, base.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, base.vocab_size, (BATCH, SEQ),
                                       dtype=np.int32)
    if base.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal((BATCH, 8, base.d_model),
                                              dtype=np.float32)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
        loss, _ = tt.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    allow_unused=True)
        out.append((loss, grads))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_saves_only_layer_inputs():
    """With remat a layer's activations are not kept for the backward
    pass: fewer saved tensors than without."""
    base = get_reduced_config("llama3.2-3b")
    tokens = torch.zeros((BATCH, SEQ), dtype=torch.int32)
    counts = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            tt.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
        counts.append(len(saved))
    assert counts[0] < counts[1] / 2, counts


@pytest.mark.parametrize("name", ARCH_NAMES[6:])
def test_train_step_matches_reference(name):
    check_train_step(name)
