"""The port's LM serving entry (``repro_torch.launch.serve.greedy_decode``
and its CLI) against the reference's (``repro.launch.serve``) on the CPU.

The decode loop runs on the reference's float32 weights
(``init_params(cfg, jax.random.key(0), jnp.float32)``, carried across by
``interop.lm_params_from_numpy``) and a seeded numpy prompt, beside a
JAX loop of the reference's jitted ``serve_step`` fed the same way: the
generated tokens must be equal, the last logits within
|got - want| <= 1e-4 + 1e-4·|want|.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_reduced_config as j_get_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

BATCH, PROMPT, GEN = 2, 6, 6
KEYS = {"arch", "batch", "prompt_len", "gen_tokens", "prefill_tok_s",
        "decode_tok_s", "sample_output", "finite"}


def j_decode(cfg, params, prompt: np.ndarray, gen_tokens: int, caches):
    """The reference's greedy loop (``repro.launch.serve.greedy_decode``)
    over its jitted ``serve_step``."""
    step = jax.jit(lambda p, c, t, pos: jt.serve_step(p, cfg, c, t, pos))
    tok = jnp.asarray(prompt[:, 0])
    for pos in range(prompt.shape[1]):
        logits, caches = step(params, caches, tok, jnp.int32(pos))
        tok = (jnp.asarray(prompt[:, pos + 1]) if pos + 1 < prompt.shape[1]
               else jnp.argmax(logits, -1).astype(jnp.int32))
    out = [np.asarray(tok)]
    for pos in range(prompt.shape[1], prompt.shape[1] + gen_tokens - 1):
        logits, caches = step(params, caches, tok, jnp.int32(pos))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1), np.asarray(logits)


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "mamba2-370m",
                                  "whisper-small"])
def test_decode_loop_matches_the_reference(name):
    jc, tc = j_get_reduced(name), get_reduced_config(name)
    pj = jax.jit(jt.init_params, static_argnums=(0, 2))(
        jc, jax.random.key(0), jnp.float32)
    prompt = np.random.default_rng(0).integers(
        0, jc.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    cache_len = PROMPT + GEN
    want_tokens, want_logits = j_decode(
        jc, pj, prompt, GEN,
        jt.init_decode_state(jc, BATCH, cache_len, jnp.float32, enc_len=8))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), pj), tc,
        torch.float32, "cpu")
    caches = tt.init_decode_state(tc, BATCH, cache_len, torch.float32,
                                  enc_len=8, device="cpu")
    run = serve.decode_loop(params, tc, caches, prompt, GEN)
    np.testing.assert_array_equal(run["tokens"].numpy(), want_tokens)
    got = run["logits"].numpy()
    assert got.shape == want_logits.shape == (BATCH, tc.vocab_size)
    assert (np.abs(got - want_logits)
            <= 1e-4 + 1e-4 * np.abs(want_logits)).all()


def test_greedy_decode_keys_are_the_reference():
    want = jserve.greedy_decode("llama3.2-3b", True, BATCH, 4, 4)
    got = serve.greedy_decode("llama3.2-3b", True, BATCH, 4, 4,
                              device="cpu")
    assert set(want) == KEYS
    assert set(got) == set(want)
    for k in KEYS:
        assert type(got[k]) is type(want[k]), k
    assert got["arch"] == want["arch"]
    assert got["finite"] is True
    assert len(got["sample_output"]) == 4


def test_greedy_decode_keeps_its_state():
    out = serve.greedy_decode("whisper-small", True, BATCH, 4, 3,
                              device="cpu", keep_state=True)
    assert set(out) == KEYS | {"params", "prompt", "prompt_logits",
                               "logits"}
    assert isinstance(out["params"], tt.LM)
    assert out["prompt"].shape == (BATCH, 4)
    assert out["prompt_logits"].shape == (BATCH, 512)


def test_cli_arch_on_the_cpu(capsys):
    serve.main(["--arch", "llama3.2-3b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen-tokens", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == KEYS
    assert out["finite"] is True
    assert out["arch"] == "llama3.2-reduced"
    assert (out["batch"], out["prompt_len"], out["gen_tokens"]) == (2, 8, 8)


def test_cli_arch_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-3b", "--reduced", "--gen-tokens",
                    "2"])


def test_cli_needs_arch_or_graph(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])
    assert "one of --arch or --bfs-graph" in capsys.readouterr().err
