"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's (``repro.models``, ``repro.configs``) on the CPU.

Every case draws the reference's ``init_params(cfg, jax.random.key(0),
dtype)`` and carries it across with ``interop.lm_params_from_numpy``;
inputs are seeded numpy.  Tolerances:

- float32: |got - want| <= 1e-4 + 1e-4·|want| for every element (logits,
  loss, every grad leaf, every cache leaf);
- bf16: rms(got - want) / rms(want) <= 2e-2 for logits, the loss within
  1e-2.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_NAMES as J_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced_config as j_get_reduced  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import psharding as jpsh  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.testing import given, settings, strategies as st  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config  # noqa: E402
from repro_torch.interop import (decode_state_from_numpy,  # noqa: E402
                                 decode_state_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import psharding as tpsh  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

CPU = "cpu"
B, S, ENC = 2, 16, 8         # batch, sequence, whisper's frames
DECODE_STEPS = 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def f32_close(got, want, what: str) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - (1e-4 + 1e-4 * np.abs(want))
    assert (excess <= 0).all(), (what, float(excess.max()),
                                 float(np.abs(got - want).max()))


def rms_ratio(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def tree_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _reference_trees(name: str) -> dict:
    """The reference's reduced-config weights in both dtypes, from one
    jitted program (eager, ``init_params`` takes up to 10 s a config)."""
    cfg = j_get_reduced(name)
    init = jax.jit(lambda key: {k: jt.init_params(cfg, key, dt[0])
                                for k, dt in DTYPES.items()})
    return init(jax.random.key(0))


def reference_tree(name: str, dtype: str):
    """The reference's ``init_params(cfg, jax.random.key(0), dtype)``."""
    return _reference_trees(name)[dtype]


@functools.lru_cache(maxsize=None)
def reference_params(name: str, dtype: str):
    """The reference's reduced-config weights, as numpy."""
    return tree_numpy(reference_tree(name, dtype))


def port_params(name: str, dtype: str):
    return lm_params_from_numpy(reference_params(name, dtype),
                                get_reduced_config(name),
                                DTYPES[dtype][1], CPU)


def batch_for(cfg, seed: int = 0, s: int = S) -> dict:
    """Seeded numpy inputs of the reduced config's frontend."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, s),
                                    dtype=np.int32)}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal((B, s, cfg.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, s),
                                       dtype=np.int32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal((B, ENC, cfg.d_model),
                                              dtype=np.float32)
    return batch


def j_batch(batch: dict, dtype) -> dict:
    return {k: (jnp.asarray(v) if v.dtype == np.int32
                else jnp.asarray(v, dtype)) for k, v in batch.items()}


def t_batch(batch: dict, dtype) -> dict:
    return {k: (torch.from_numpy(v) if v.dtype == np.int32
                else torch.from_numpy(v).to(dtype)) for k, v in batch.items()}


# -- configs -----------------------------------------------------------------

def test_arch_names_in_the_reference_order():
    assert ARCH_NAMES == J_ARCH_NAMES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_equal(name):
    for jget, tget in ((j_get_config, get_config),
                       (j_get_reduced, get_reduced_config)):
        jc, tc = jget(name), tget(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.vocab_padded == jc.vocab_padded
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert (tc.is_moe, tc.is_attention_free, tc.subquadratic) == (
            jc.is_moe, jc.is_attention_free, jc.subquadratic)
        assert tconfig.layer_plan_kinds(tc) == jconfig.layer_plan_kinds(jc)
        assert tconfig.layer_segments(tc) == jconfig.layer_segments(jc)


def test_llama3_8b_full_size():
    cfg = get_config("llama3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 8, 14336, 128256)
    assert cfg.param_count() == 7_504_658_432
    params = tt.abstract_params(cfg)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model   # param_count omits them
    assert sum(p.numel() for p in params.parameters()) == \
        cfg.param_count() + norms
    assert all(p.device.type == "meta" for p in params.parameters())


# -- forward, loss and grads -------------------------------------------------

def _j_logits(p, cfg, b):
    return jt.forward_train(p, cfg, b.get("tokens"), b.get("embeds"),
                            b.get("frames"))[0]


def _j_train(name: str):
    """One jitted program: the reference's loss, metrics and grads, and
    its logits."""
    cfg = j_get_reduced(name)
    vg = jax.value_and_grad(lambda p, b: jt.loss_fn(p, cfg, b), has_aux=True)
    return jax.jit(lambda p, b: (vg(p, b), _j_logits(p, cfg, b)))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_f32_logits_loss_and_grads(name):
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    batch = batch_for(jc)
    pj = reference_tree(name, "f32")
    bj = j_batch(batch, jnp.float32)
    ((lj, mj), gj), logits_j = _j_train(name)(pj, bj)

    params = port_params(name, "f32")
    bt = t_batch(batch, torch.float32)
    lt, mt = tt.loss_fn(params, tc, bt)
    lt.backward()
    f32_close(lt.detach(), lj, "loss")
    f32_close(mt["aux"].detach(), mj["aux"], "aux")
    with torch.no_grad():
        logits_t, _ = tt.forward_train(params, tc, bt.get("tokens"),
                                       bt.get("embeds"), bt.get("frames"))
        f32_close(logits_t, logits_j, "logits")
        for p in params.parameters():
            assert p.grad is not None
            p.copy_(p.grad)
    got = lm_params_to_numpy(params)
    want = tree_numpy(gj)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        f32_close(g, w, f"grad {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_logits_and_loss(name):
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    batch = batch_for(jc, seed=1)
    pj = reference_tree(name, "bf16")
    bj = j_batch(batch, jnp.bfloat16)
    logits_j, loss_j = jax.jit(lambda p, b: (
        _j_logits(p, jc, b), jt.loss_fn(p, jc, b)[0]))(pj, bj)

    params = port_params(name, "bf16")
    bt = t_batch(batch, torch.bfloat16)
    with torch.no_grad():
        logits_t, _ = tt.forward_train(params, tc, bt.get("tokens"),
                                       bt.get("embeds"), bt.get("frames"))
        loss_t, _ = tt.loss_fn(params, tc, bt)
    assert logits_t.dtype == torch.bfloat16
    assert rms_ratio(logits_t.float(), logits_j) <= 2e-2
    assert abs(float(loss_t) - float(loss_j)) <= 1e-2


# -- decode ------------------------------------------------------------------

def random_caches(cfg, batch: int, cache_len: int, seed: int) -> list:
    """The reference's ``init_decode_state`` shapes (f32) filled with
    seeded values: every leaf the step reads is exercised, the
    cross-attention cache included."""
    rng = np.random.default_rng(seed)
    caches = jt.init_decode_state(cfg, batch, cache_len, jnp.float32,
                                  enc_len=ENC)
    return [{k: rng.standard_normal(v.shape, dtype=np.float32) * 0.5
             for k, v in c.items()} for c in caches]


def run_decode(name: str, cfg_j, cfg_t, caches: list, steps: int,
               seed: int) -> None:
    """``steps`` serve_step positions from 0 under both packages (f32),
    logits and every cache leaf compared after each."""
    pj = reference_tree(name, "f32")
    params = port_params(name, "f32")
    step_j = jax.jit(lambda p, c, t, pos: jt.serve_step(p, cfg_j, c, t, pos))
    tokens = np.random.default_rng(seed).integers(
        0, cfg_j.vocab_size, (steps, B), dtype=np.int32)
    cj = jax.tree.map(jnp.asarray, caches)
    ct = decode_state_from_numpy(caches, torch.float32, CPU)
    for pos in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[pos]), jnp.int32(pos))
        with torch.no_grad():
            lt, ct = tt.serve_step(params, cfg_t, ct,
                                   torch.from_numpy(tokens[pos]), pos)
        assert lt.shape == (B, cfg_t.vocab_size)
        f32_close(lt, lj, f"logits at {pos}")
        for i, (a, b) in enumerate(zip(decode_state_to_numpy(ct),
                                       tree_numpy(cj))):
            assert a.keys() == b.keys()
            for k in a:
                f32_close(a[k], b[k], f"segment {i} cache {k} at {pos}")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serve_steps(name):
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    run_decode(name, jc, tc, random_caches(jc, B, 8, seed=2),
               DECODE_STEPS, seed=3)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "gemma3-4b"])
def test_ring_decode_past_the_window(name):
    """Window 8, cache 32: the ring wraps twice in 20 positions (gemma3's
    global layer keeps the full 32-slot cache)."""
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    caches = jt.init_decode_state(jc, B, 32, jnp.float32)
    lens = [c["k"].shape[2] for c in caches]
    assert 8 in lens
    run_decode(name, jc, tc, tree_numpy(caches), 20, seed=4)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_decode_state_shapes_and_dtypes(name):
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    want = jt.init_decode_state(jc, B, 24, enc_len=ENC)
    got = tt.init_decode_state(tc, B, 24, enc_len=ENC, device=CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert tuple(g[k].shape) == w[k].shape, k
            assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype)
            assert not g[k].any()


def test_init_decode_state_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tt.init_decode_state(get_reduced_config("llama3-8b"), B, 8)


# -- params across -----------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper-small", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "mamba2-370m"])
def test_params_round_trip_same_bits(name):
    tree = reference_params(name, "bf16")
    params = port_params(name, "bf16")
    assert params.embed.dtype == torch.bfloat16
    back = lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_init_params_from_a_generator():
    cfg = get_reduced_config("recurrentgemma-2b")
    a = tt.init_params(cfg, torch.Generator().manual_seed(5))
    b = tt.init_params(cfg, torch.Generator().manual_seed(5))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == (torch.float32 if n.endswith(
            ("ln1", "ln2", "final_ln", "lam")) else torch.bfloat16), n
        assert torch.equal(p, q), n
    ref = jax.tree.leaves(jt.abstract_params(
        j_get_reduced("recurrentgemma-2b")))
    got = jax.tree.leaves(lm_params_to_numpy(a))
    assert [x.shape for x in got] == [x.shape for x in ref]
    # the fixed recurrence constants are the reference's numpy draws
    lam = reference_params("recurrentgemma-2b", "bf16")["segments"][0][
        "rglru"]["lam"]
    np.testing.assert_array_equal(
        a.segments[0][0].rglru.lam.detach().numpy(), lam[0])


# -- long sequences: the chunked flash path ------------------------------------

@pytest.mark.parametrize("name", ["llama3-8b", "h2o-danube-1.8b"])
def test_chunked_flash_path(name):
    """``flash_threshold=16`` forces the 1024-chunk online softmax at
    S = 2048 (h2o-danube: with its window of 8)."""
    jc = dataclasses.replace(j_get_reduced(name), flash_threshold=16)
    tc = dataclasses.replace(get_reduced_config(name), flash_threshold=16)
    tokens = np.random.default_rng(6).integers(0, jc.vocab_size, (1, 2048),
                                               dtype=np.int32)
    pj = reference_tree(name, "f32")
    want, _ = jax.jit(lambda p, t: jt.forward_train(p, jc, t))(
        pj, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tt.forward_train(port_params(name, "f32"), tc,
                                  torch.from_numpy(tokens))
    f32_close(got, want, "logits")


# -- psharding ---------------------------------------------------------------

class _FakeMesh:
    def __init__(self, shape):
        self._shape = dict(shape)

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape


def _entries(spec):
    return None if spec is None else tuple(spec)


@settings(max_examples=50, deadline=None)
@given(st.tuples(st.integers(1, 512), st.integers(1, 512),
                 st.integers(1, 512)),
       st.sampled_from([("batch", "seq", "ff"), ("batch", None, "heads"),
                        ("experts", None, None), ("vocab", "kv_seq", "q_seq")]))
def test_spec_for_matches_the_reference(shape, logical):
    mesh = _FakeMesh([("pod", 2), ("data", 16), ("model", 16)])
    got = tpsh.spec_for(shape, logical, mesh)
    assert got == _entries(jpsh.spec_for(shape, logical, mesh))
    if got is None:
        return
    sizes = dict(mesh.shape)
    for dim, entry in enumerate(got):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert shape[dim] % int(np.prod([sizes[a] for a in axes])) == 0


def test_rules_and_tp_size():
    assert tpsh.RULES == jpsh.RULES
    assert tpsh.tp_size() == 1
    x = torch.ones(3)
    assert tpsh.constrain(x, "batch") is x


# -- SSD: chunked against decode -----------------------------------------------

_J_SSM = jax.jit(jssm.ssm_forward,
                 static_argnames=("expand", "head_dim", "state", "chunk"))


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 30))
def test_ssd_chunked_matches_decode(seed):
    """The port's chunked SSD forward equals its single-step recurrence
    (within the reference's own 5e-4) and the reference's chunked
    forward (f32 tolerance)."""
    bsz, s, d, expand, hd, n, cw = 1, 19, 8, 2, 4, 4, 4
    pj = jssm.ssm_params(jax.random.key(seed % 1000), d, expand, hd, n, cw,
                         jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(seed % 991), (bsz, s, d),
                                     jnp.float32) * 0.3)
    want = _J_SSM(jnp.asarray(x), pj, expand=expand, head_dim=hd, state=n,
                  chunk=8)
    p = tssm.SSM(d, expand, hd, n, cw, torch.float32)
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in pj.items()})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tssm.ssm_forward(xt, p, expand=expand, head_dim=hd, state=n,
                               chunk=8)
        cache = tssm.ssm_init_cache(bsz, d, expand, hd, n, cw, torch.float32)
        ys = []
        for t in range(s):
            yt, cache = tssm.ssm_decode(xt[:, t:t + 1], p, cache,
                                        expand=expand, head_dim=hd, state=n)
            ys.append(yt)
    f32_close(got, want, "chunked")
    np.testing.assert_allclose(got.numpy(), torch.cat(ys, 1).numpy(),
                               atol=5e-4)
