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

Across ranks (a started process group) the file is the one a single
rank writes, as the reference's checkpoints of a sharded state are:
:func:`snapshot` gathers each ``DTensor`` leaf to its whole value, a
collective every rank makes in the same leaf order, and copies it to
rank 0's host at once, so the device holds one whole leaf at a time;
only rank 0 keeps the host arrays and writes.  :func:`latest_step` is
rank 0's answer broadcast to every rank, and :func:`restore` is elastic,
as the reference's: every rank reads the whole ``arrays.npz`` and places
its own block by the shardings of whatever mesh it restores on, so a
checkpoint of any number of ranks (or of the reference) restores on any
other.  The cost: rank 0 holds the whole state on its host once for each
save (a segment's layers are copied straight into their stacked array,
never held twice), and during a restore every rank holds the whole
checkpoint on its host.
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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

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


def _started() -> bool:
    """True inside a started process group: every rank then takes part in
    each collective of a save, a restore's step lookup and a wait."""
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _started() else 0


def _barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _whole(leaf):
    """A leaf's whole value: a ``DTensor`` gathered from every rank (a
    collective), a tensor detached, anything else as it is."""
    if isinstance(leaf, DTensor):
        return leaf.detach().full_tensor()
    return leaf.detach() if torch.is_tensor(leaf) else leaf


def _host_dtype(leaf) -> np.dtype:
    """The dtype a leaf is stored in: bf16 as uint16 bits."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_host_dtype(leaf))


def _copy_into(out: np.ndarray, leaf) -> None:
    """``out[...] = leaf`` for a tensor (bf16 as its bits) or an array."""
    if not torch.is_tensor(leaf):
        out[...] = leaf
    elif leaf.dtype == torch.bfloat16:
        torch.from_numpy(out.view(np.int16)).copy_(leaf.view(torch.int16))
    else:
        torch.from_numpy(out).copy_(leaf)


def snapshot(tree) -> tuple[dict, dict]:
    """(arrays, dtypes) keyed by the reference's paths: host copies of the
    whole leaves, a segment's layers stacked.  In a started process group
    every rank must call it (each ``DTensor`` leaf is gathered, leaf by
    leaf); only rank 0 gets the arrays, the others an empty dict."""
    items = list(_items(tree))
    counts: dict[str, int] = {}
    for key, layer, _ in items:
        if layer is not None:
            counts[key] = max(counts.get(key, 0), layer + 1)
    keep = _rank() == 0
    arrays, dtypes = {}, {}
    for key, layer, leaf in items:
        dtypes[key] = _dtype_name(leaf)
        whole = _whole(leaf)
        if not keep:
            continue
        if layer is None:
            arrays[key] = np.empty(np.shape(whole), _host_dtype(whole))
            _copy_into(arrays[key], whole)
            continue
        if key not in arrays:               # a segment's layers, stacked
            arrays[key] = np.empty((counts[key], *np.shape(whole)),
                                   _host_dtype(whole))
        _copy_into(arrays[key][layer, ...], whole)
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
    """Write ``tree`` as the checkpoint of ``step``; returns its directory.
    In a started process group every rank calls it, rank 0 writes, and
    every rank returns once the checkpoint is in place."""
    arrays, dtypes = snapshot(tree)
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    if _rank() == 0:
        _write(ckpt_dir, step, arrays, dtypes, extra)
    if _started():
        _barrier()
    return path


class AsyncCheckpointer:
    """Serialize+write on a background thread; at most one in flight.

    In a started process group every rank makes each call: ``save``
    gathers the snapshot on the calling thread of every rank before it
    returns, rank 0 alone writes on its thread, and ``wait`` joins that
    writer and then meets the other ranks at a barrier, so after it no
    rank looks for a checkpoint that rank 0 has not renamed yet."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _started():
            _barrier()

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        arrays, dtypes = snapshot(tree)        # device->host here
        if _rank() != 0:
            return

        def work():
            _write(self.ckpt_dir, step, arrays, dtypes, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step under ``ckpt_dir`` (None for none); in a started
    process group rank 0's answer, broadcast to every rank."""
    step = None
    if _rank() == 0 and os.path.isdir(ckpt_dir):
        steps = [int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                 if d.startswith("step-")]
        step = max(steps) if steps else None
    if _started():
        box = [step]
        dist.broadcast_object_list(box, src=0)
        step = box[0]
    return step


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
    # no host copy here: placing copies to the device, or cuts a block
    t = value if torch.is_tensor(value) else torch.from_numpy(
        np.asarray(value))
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
    ``NamedSharding``) places each tensor on its mesh's device: on a mesh
    of more than one rank a ``DTensor`` whose block this rank cuts from
    the whole leaf it read (nothing moves between ranks), an ``LM``'s
    parameters as ``distribute_params`` gives them."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(path, "manifest.json")) as mf:
        manifest = json.load(mf)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        loaded = {k: _decode(z[k], dtypes.get(k)) for k in z.files}
    return _rebuild(like_tree, shardings, loaded), manifest
