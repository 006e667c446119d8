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

The LM stack's weights are the reference's ``init_params`` pytree as
numpy (``lm_params_from_numpy`` / ``lm_params_to_numpy``), its decode
caches ``init_decode_state``'s list (``decode_state_from_numpy`` /
``decode_state_to_numpy``).
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


# -- the LM stack: parameter trees and decode caches -----------------------

def _tensor_like(values, like: torch.Tensor, device) -> torch.Tensor:
    """numpy values (f32 for a bf16 leaf) -> a tensor of ``like``'s dtype."""
    if like.dtype == torch.bfloat16:
        return bf16_from_numpy(values, device)
    return torch.from_numpy(np.array(values, dtype=np.float32)).to(
        device=resolve_device(device), dtype=like.dtype)


def _segment_leaf(tree: dict, name: str):
    """The reference's leaf for a port parameter name: ``segments.i.j.a.b``
    is ``tree["segments"][i]["a"]["b"][j]`` (each segment stacked over
    its layers); any other name is a path of dict keys."""
    parts = name.split(".")
    if parts[0] != "segments":
        node = tree
        for k in parts:
            node = node[k]
        return node
    node = tree["segments"][int(parts[1])]
    for k in parts[3:]:
        node = node[k]
    return np.asarray(node)[int(parts[2])]


def lm_params_from_numpy(tree: dict, cfg, dtype=torch.bfloat16,
                         device=None):
    """A port ``models.LM`` from the reference's parameter pytree as numpy
    (``embed``, ``final_ln``, ``enc_final_ln``, and ``segments`` stacked
    ``[count, ...]``), on ``device`` (None = the CUDA card).  Leaves the
    port holds in ``dtype`` (the reference's ``init_params`` dtype)
    arrive as f32 numpy and are rounded by :func:`bf16_from_numpy`, exact
    for values that are bf16 already; float32 leaves (norms, router,
    recurrence constants) stay float32."""
    from repro_torch.models.transformer import abstract_params
    params = abstract_params(cfg, dtype)
    values = {name: _tensor_like(_segment_leaf(tree, name), p, device)
              for name, p in params.named_parameters()}
    for name, p in params.named_parameters():
        if tuple(values[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(values[name].shape)}, "
                             f"the model's is {tuple(p.shape)}")
    params.load_state_dict(values, assign=True)
    return params


def lm_params_to_numpy(params) -> dict:
    """The reference's parameter pytree (f32 numpy, segments stacked
    ``[count, ...]``) from a port ``models.LM``; bf16 leaves widen
    exactly, so a round trip gives back the same bits."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    tree: dict = {"embed": arr(params.embed),
                  "final_ln": arr(params.final_ln), "segments": []}
    if hasattr(params, "enc_final_ln"):
        tree["enc_final_ln"] = arr(params.enc_final_ln)
    for seg in params.segments:
        stacked: dict = {}
        for name, _ in seg[0].named_parameters():
            node = stacked
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.stack([arr(layer.get_parameter(name))
                                   for layer in seg])
        tree["segments"].append(stacked)
    return tree


def decode_state_from_numpy(caches: list, dtype=torch.bfloat16,
                            device=None) -> list:
    """The port's decode caches from the reference's (one dict a segment
    of f32 numpy leaves, stacked over its layers): the recurrent state
    ``h`` float32, every other leaf ``dtype``."""
    def one(name, v):
        like = torch.empty(0, dtype=torch.float32 if name == "h" else dtype)
        return _tensor_like(v, like, device)

    return [{k: one(k, v) for k, v in c.items()} for c in caches]


def decode_state_to_numpy(caches: list) -> list:
    """The reference's decode caches (f32 numpy) from the port's."""
    return [{k: v.detach().float().cpu().numpy() for k, v in c.items()}
            for c in caches]
