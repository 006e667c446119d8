"""Launch wrapper of the flash-attention kernel.

Port of ``repro.kernels.flash_attention`` (``flash_attention_pallas``).
One kernel, hand-written in CUDA C++ for Hopper
(``csrc/flash_attention.cu``, whose header note gives its bound and
design):

* ``flash_attention`` (K7) — causal or full softmax attention over q/k/v
  ``[BH, S, hd]`` (heads flattened, KV already repeated), an online
  softmax with f32 statistics, the output in q's dtype.  bf16 runs on the
  tensor cores (wgmma, P split into two bf16 terms); f32 runs on the CUDA
  cores, since the tensor cores would round f32 operands to TF32.

The contract is the reference's: ``block_q`` and ``block_k`` must divide
``S`` (the reference asserts it; this raises ValueError).  They fix
nothing in the kernel, whose tiles are its own (128 query rows and
128 keys in bf16, 64 and 64 in f32) and which masks a ragged last tile
itself; in the reference they only fix the order of summation.  There is no
``interpret`` argument.  A tensor on the CPU goes to the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises.  The wrapper
counts its launches in ``LAUNCHES`` and reports each call to the step
analysis counting, if any, at :func:`attention_cost`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _report, ref
from repro_torch.kernels._build import check_arg, raise_on_error, stream_ptr

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (32, 64, 128)           # the head dims the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "flash_attention"
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load(_LIB)
    if not _bound:
        p, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f = lib.flash_attention_launch
        f.argtypes = [p, p, p, p, i, i, i, i, i, f32, p]
        f.restype = i
        _bound = True
    return lib


def attention_cost(q: torch.Tensor, causal: bool) -> tuple[int, float]:
    """K7's (bytes, FLOPs): q, k and v read and the output written once;
    4·S²·hd FLOPs a head (the two products), half of them when causal."""
    bh, s, hd = q.shape
    flops = 4.0 * bh * s * s * hd
    return 4 * q.numel() * q.element_size(), flops / 2 if causal else flops


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Softmax attention, ``softmax(q k^T / sqrt(hd)) v`` (K7).

    q/k/v: [BH, S, hd], f32 or bf16, one shape.  ``causal`` masks keys
    after each query.  ``block_q``/``block_k`` must divide ``S``.
    Returns [BH, S, hd] in q's dtype.  The blocks do not tile the
    kernel (see the module note)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [BH, S, hd] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, hd = q.shape
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must "
                         f"divide S = {s}")
    if _report.active is not None:
        return _report.active.kernel_call(
            "flash_attention", lambda: attention_cost(q, causal),
            flash_attention, q, k, v, causal=causal, block_q=block_q,
            block_k=block_k)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_arg(name, t, q.dtype, 3, dev)
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel loads by TMA: 16-byte aligned bases
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not built (kernel takes "
                         f"{HEAD_DIMS})")
    out = torch.empty_like(q)
    if bh and s:
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(bh),
            int(s), int(hd), int(bool(causal)), _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(hd), stream_ptr(dev))
        raise_on_error(err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
