"""The port's flash attention (K7) against the reference's.

On the CPU ``flash_attention`` runs its plain version, so these tests hold
the wrapper and the plain version against the reference's Pallas kernel
in interpret mode and its oracle, over the sweeps of
``tests/test_flash_kernel.py`` (blocks, dtypes, head dims, causal and
full).  Inputs are made by numpy from a seed and cast to bf16 in both
packages.  Tolerances are the reference test's: 3e-5 for f32, 2e-2 for
bf16 (one bf16 rounding of outputs of order 1).  ``tests/test_torch_cuda.py``
holds the CUDA kernel against the plain version on the card.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp                              # noqa: E402
import torch                                         # noqa: E402

from repro.kernels import ref as jref                # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.interop import bf16_from_numpy      # noqa: E402
from repro_torch.kernels import ref                  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402


def _inputs(bh, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, hd)).astype(np.float32)
            for _ in range(3)]


def _run(bh, s, hd, bq, bk, causal, bf16, seed=0):
    qkv = _inputs(bh, s, hd, seed)
    if bf16:
        tq, tk, tv = (bf16_from_numpy(a, "cpu") for a in qkv)
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in qkv)
    else:
        tq, tk, tv = (torch.from_numpy(a) for a in qkv)
        jq, jk, jv = (jnp.asarray(a) for a in qkv)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.to(torch.float32).numpy()
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, block_q=bq, block_k=bk), np.float32)
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                        np.float32)
    tol = 2e-2 if bf16 else 3e-5
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=0)
    return got


@pytest.mark.parametrize("s,bq,bk", [(256, 128, 128), (256, 64, 256),
                                     (512, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_blocks(s, bq, bk, causal):
    _run(2, s, 64, bq, bk, causal, bf16=False)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_dtypes_headdims(bf16, hd):
    _run(1, 256, hd, 128, 128, True, bf16)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_flash_seeds(seed):
    """The reference's property run, on fixed numpy seeds."""
    _run(2, 256, 32, 128, 128, True, bf16=False, seed=seed)


def test_flash_causal_first_row_is_v0():
    """Under the causal mask the first query sees only key 0."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 128, 32, 9))
    out = flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    torch.testing.assert_close(out[:, 0], v[:, 0], atol=0, rtol=0)


def test_flash_plain_is_the_wrappers_cpu_path():
    q, k, v = (bf16_from_numpy(a, "cpu") for a in _inputs(1, 128, 64, 5))
    for causal in (True, False):
        assert torch.equal(flash_attention(q, k, v, causal=causal,
                                           block_q=32, block_k=128),
                           ref.flash_attention_ref(q, k, v, causal=causal))


def test_flash_rejects_blocks_that_do_not_divide_s():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 96, 32, 0))
    for bq, bk in ((64, 32), (32, 64), (0, 32)):
        with pytest.raises(ValueError, match="divide"):
            flash_attention(q, k, v, block_q=bq, block_k=bk)
    with pytest.raises(AssertionError):               # the reference asserts
        flash_attention_pallas(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), block_q=64, block_k=32)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :64], v, block_q=32, block_k=32)


def _emulate_kernel_rounding(q, k, v, split):
    """The bf16 kernel's arithmetic in plain torch: bf16 q/k/v, f32 scores
    and softmax statistics, P V with bf16 operands and f32 sums (exact
    products), P either rounded to bf16 once or split into bf16 hi + lo;
    the output rounded once to bf16."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = torch.bmm(qf, kf.transpose(1, 2)) / np.sqrt(q.shape[-1])
    s.masked_fill_(torch.ones(s.shape[1:], dtype=torch.bool).triu_(1),
                   float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).to(torch.float32)
    pv = torch.bmm(hi, vf)
    if split:
        lo = (p - hi).to(torch.bfloat16).to(torch.float32)
        pv += torch.bmm(lo, vf)
    return (pv / denom).to(torch.bfloat16)


def test_flash_p_split_is_needed_for_the_card_tolerance():
    """Why the bf16 kernel feeds P to the tensor cores as two bf16 terms:
    at [2, 2048, 128] causal, P rounded once to bf16 breaks the card's
    elementwise bound |got - want| <= 1e-3 + 8e-3 |want|, and the hi + lo
    split holds it with an rms ratio far under 1e-2.  This emulates the
    kernel's rounding; it does not run the kernel."""
    q, k, v = (bf16_from_numpy(a, "cpu") for a in _inputs(2, 2048, 128, 21))
    want = ref.flash_attention_ref(q, k, v, causal=True).to(torch.float32)
    bound = 1e-3 + 8e-3 * want.abs()
    shares = {}
    for split in (False, True):
        got = _emulate_kernel_rounding(q, k, v, split).to(torch.float32)
        d = (got - want).abs()
        shares[split] = float((d / bound).max())
        rms = float(d.square().mean().sqrt() / want.square().mean().sqrt())
        if split:
            assert rms <= 1e-2
    assert shares[True] < 1 < shares[False], shares
