"""Carry the reference's data across to the port.

For this system the "weights" are the graph and the plane state.  The
reference keeps ``LocalGraph`` fields as uint32/int32/bool arrays and
plane words as uint32; the port keeps the same bits in torch tensors
(plane words as int32).  The functions here take and give numpy arrays,
so neither package imports the other.  ``planes_from_numpy`` and
``planes_to_numpy`` take words of any shape: the batched planes
``[n_pad, nw]`` and the single-source frontier and visited words
``[n_pad / 32]``.  Level rows and statvecs (int32[7], or int32[8] with
integrity checking) are int32 in both packages and need only
``torch.from_numpy``.

The block-sparse SpMV and flash attention take bf16, which numpy lacks:
``bf16_from_numpy`` rounds f32 numpy values to bf16 to nearest even, as
JAX's ``astype(jnp.bfloat16)`` does, so both packages see the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bfs_local import FIELDS, LocalGraph
from repro_torch.device import resolve_device


def local_graph_from_numpy(fields: dict[str, np.ndarray], n: int, n_pad: int,
                           device=None) -> LocalGraph:
    """A port ``LocalGraph`` from the reference's fields (``np.asarray``
    of each), on ``device`` (None = the CUDA card)."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise ValueError(f"missing LocalGraph fields: {missing}")
    dev = resolve_device(device)
    out = {}
    for k in FIELDS:
        dtype = np.bool_ if k == "in_seg_first" else np.int32
        # a copy: the reference's arrays come back read-only
        out[k] = torch.from_numpy(np.array(fields[k], dtype=dtype)).to(dev)
    return LocalGraph(n=int(n), n_pad=int(n_pad), **out)


def planes_from_numpy(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words (any shape) -> int32 tensor with the same bits."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(w.view(np.int32).copy()).to(
        resolve_device(device))


def planes_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 plane-word tensor -> uint32 numpy words with the same bits."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def bf16_from_numpy(values: np.ndarray, device=None) -> torch.Tensor:
    """f32 numpy values (any shape) -> bf16 tensor on ``device`` (None =
    the CUDA card), rounded to nearest even on the host."""
    a = np.array(values, dtype=np.float32)          # a writable copy
    return torch.from_numpy(a).to(torch.bfloat16).to(resolve_device(device))
