"""Checkpoints: atomic, async-capable, in the reference's on-disk format
(port of ``repro.ckpt.checkpoint``).

Format: one ``arrays.npz`` per checkpoint step holding every leaf,
addressed by its ``/``-joined key path as the reference's
``jax.tree_util`` paths name it (a list index as ``[i]``), plus a
``manifest.json``; saves go through ``.tmp-<step>`` and a rename under
``step-%08d``.  Either package restores the other's checkpoints.

The port's trees map onto the reference's layout: an ``LM`` (or a mapping
keyed by its parameter names, as the optimizer's ``m`` and ``v`` are)
becomes ``embed``, ``final_ln``, ``enc_final_ln`` and ``segments``, one
dict a segment whose leaves stack its layers ``[count, ...]``, so the
train state's keys are ``params/segments/[0]/attn/wq``,
``opt/m/embed``, ``opt/step`` and so on.  Other mappings, lists and
leaves (tensors, numpy arrays) keep their own structure.  bf16 is stored
as its uint16 bits with dtype ``"bfloat16"`` in the manifest.

``AsyncCheckpointer.save`` copies every leaf to the host before it
returns (the train step updates the state in place afterwards), then
writes on a background thread.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import threading
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import reference_path


def _items(tree, prefix: tuple = ()):
    """(key, layer, leaf) for every leaf of ``tree``: ``key`` the
    reference's path, ``layer`` the leaf's index in its stacked
    ``[count, ...]`` array or None."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if "." in str(k):                   # a parameter name
                path, layer = reference_path(k)
                yield "/".join((*prefix, *path)), layer, v
            else:
                yield from _items(v, (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, (*prefix, f"[{i}]"))
    else:
        yield "/".join(prefix), None, tree


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor or array; bf16 as its uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def snapshot(tree) -> tuple[dict, dict]:
    """(arrays, dtypes) keyed by the reference's paths: host copies, a
    segment's layers stacked."""
    layers: dict[str, dict[int, np.ndarray]] = {}
    arrays, dtypes = {}, {}
    for key, layer, leaf in _items(tree):
        dtypes[key] = _dtype_name(leaf)
        if layer is None:
            arrays[key] = _host(leaf)
        else:
            layers.setdefault(key, {})[layer] = _host(leaf)
    for key, by_layer in layers.items():
        arrays[key] = np.stack([by_layer[j] for j in sorted(by_layer)])
    return arrays, dtypes


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict,
           extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "num_leaves": len(arrays), "dtypes": dtypes,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    arrays, dtypes = snapshot(tree)
    return _write(ckpt_dir, step, arrays, dtypes, extra)


class AsyncCheckpointer:
    """Serialize+write on a background thread; at most one in flight."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        arrays, dtypes = snapshot(tree)        # device->host here

        def work():
            _write(self.ckpt_dir, step, arrays, dtypes, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step-")]
    return max(steps) if steps else None


def _decode(arr: np.ndarray, want: str | None):
    """A stored array as a tensor (bf16 from its bits) or numpy array."""
    if want == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if want and str(arr.dtype) != want:
        return arr.view(np.dtype(want))
    return arr


def _leaf(value, layer, like, sharding):
    """One restored leaf shaped and typed as ``like``: a tensor on the
    sharding's device (else ``like``'s, the CPU for ``meta``), or a numpy
    array for a numpy ``like``."""
    if layer is not None:
        value = value[layer]
    if not torch.is_tensor(like):
        if torch.is_tensor(value):          # bf16 into numpy: widen
            return value.float().numpy()
        return np.array(value)
    t = value if torch.is_tensor(value) else torch.from_numpy(
        np.array(value))
    if sharding is not None:
        from repro_torch.launch.shardings import place
        t = place(t, sharding)
    elif like.device.type != "meta":
        t = t.to(like.device)
    t = t.to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"restored shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    return t


def _rebuild(like, shardings, loaded, prefix: tuple = ()):
    """``like``'s structure with every leaf taken from ``loaded`` (key ->
    decoded array)."""
    if isinstance(like, nn.Module):
        named = dict(like.named_parameters())
        values = _rebuild(named, shardings, loaded, prefix)
        # a skeleton of ``like`` whose parameters are meta tensors: no copy
        memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                    requires_grad=p.requires_grad)
                for p in named.values()}
        module = copy.deepcopy(like, memo)
        module.load_state_dict(values, assign=True)
        return module
    if isinstance(like, Mapping):
        out = {}
        for k, v in like.items():
            sub = shardings[k] if shardings is not None else None
            if "." in str(k):                   # a parameter name
                path, layer = reference_path(k)
                out[k] = _leaf(loaded["/".join((*prefix, *path))], layer, v,
                               sub)
            else:
                out[k] = _rebuild(v, sub, loaded, (*prefix, str(k)))
        return out
    if isinstance(like, (list, tuple)):
        return type(like)(
            _rebuild(v, shardings[i] if shardings is not None else None,
                     loaded, (*prefix, f"[{i}]"))
            for i, v in enumerate(like))
    return _leaf(loaded["/".join(prefix)], None, like, shardings)


def restore(ckpt_dir: str, step: int, like_tree, shardings=None):
    """Load leaves into ``like_tree``'s structure: returns (tree,
    manifest).

    ``like_tree`` gives the structure, shapes and dtypes (e.g. the
    abstract train state on ``meta``; an ``LM`` comes back as a new
    ``LM``); ``shardings`` (the same structure, ``launch.shardings``'
    ``NamedSharding``) places each tensor on its mesh's device."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(path, "manifest.json")) as mf:
        manifest = json.load(mf)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        loaded = {k: _decode(z[k], dtypes.get(k)) for k in z.files}
    return _rebuild(like_tree, shardings, loaded), manifest
