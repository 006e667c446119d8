"""Sharding rules: parameters, optimizer state, batches, decode caches
(port of ``repro.launch.shardings``).

Auto-spec assigns mesh axes to tensor dims from an ordered preference list,
skipping any assignment that does not divide evenly (so GQA kv-heads fall
back to head_dim TP, batch=1 falls back to sequence sharding, etc.).

A spec is a tuple with one entry a dim, each a mesh axis name, a tuple of
names or None: the entries of the reference's ``PartitionSpec``.  The
rules are the reference's, over a ``{axis: size}`` dict.  The reference
stacks a segment's parameters ``[count, ...]``; the port keeps one tensor
a layer, so :func:`param_shardings` computes each spec on the stacked
shape (dims counted from the end, so the count dim takes no axis) and
gives the layer's tensor the spec without its leading entry.

Placement: a :class:`NamedSharding` holds its mesh and spec, and
:func:`place` puts a tensor on it.  On a mesh of more than one rank that
gives a ``DTensor`` (PyTorch's SPMD tensor, the counterpart of a GSPMD
array) whose placements are the spec's (:func:`spec_placements`): each
rank keeps its own block of a tensor it holds whole, and a ``meta``
tensor (the reference's ``ShapeDtypeStruct``) becomes a DTensor of
``meta`` blocks, or of zero-filled blocks on the mesh's device with
``zeros=True`` (the dry-run on the card), so a rank never allocates more
than its block.  :func:`distribute_params` does this to an ``LM``'s
parameters, or to AdamW's moments, by :func:`param_shardings`.  On a
``LocalMesh`` (one rank) a sharding only moves a tensor to the mesh's
device, and every step computes what it computes unsharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.mesh import LocalMesh, mesh_device
from repro_torch.models.psharding import mesh_axes
from repro_torch.models.psharding import placements as spec_placements
from repro_torch.models.transformer import reference_path

DP_AXES = ("pod", "data")
TP_AXIS = "model"


def _axes_size(mesh_shape: dict, axes: tuple[str, ...]) -> int:
    return int(np.prod([mesh_shape.get(a, 1) for a in axes]))


def pick_spec(shape: tuple[int, ...], prefs: list[tuple[int, tuple[str, ...]]],
              mesh_shape: dict) -> tuple:
    """Assign mesh axes to dims by priority, honoring divisibility."""
    spec: list[Any] = [None] * len(shape)
    used: set[str] = set()
    for dim, axes in prefs:
        axes = tuple(a for a in axes if a in mesh_shape)
        if not axes or any(a in used for a in axes) or dim >= len(shape):
            continue
        if spec[dim] is not None:
            continue
        if shape[dim] % _axes_size(mesh_shape, axes) != 0:
            continue
        spec[dim] = axes if len(axes) > 1 else axes[0]
        used.update(axes)
    return tuple(spec)


# preference tables keyed by parameter leaf name; dims are offsets from the
# *end* of the shape so stacked [count, ...] segment params reuse the rules.
_PARAM_PREFS = {
    # attention projections [d, h|hkv, hd]: heads -> head_dim -> fsdp(d)
    "wq": [(-2, (TP_AXIS,)), (-1, (TP_AXIS,)), (-3, ("data",))],
    "wk": [(-2, (TP_AXIS,)), (-1, (TP_AXIS,)), (-3, ("data",))],
    "wv": [(-2, (TP_AXIS,)), (-1, (TP_AXIS,)), (-3, ("data",))],
    "wo": [(-3, (TP_AXIS,)), (-2, (TP_AXIS,)), (-1, ("data",))],
    # MLP [d, f] / [f, d]
    "w_gate": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_up": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_down": [(-2, (TP_AXIS,)), (-1, ("data",))],
    # embedding [V, d]: vocab TP + fsdp on d
    "embed": [(-2, (TP_AXIS,)), (-1, ("data",))],
    # ssm / rglru projections [d, p]; per-stream mamba2 weights shard their
    # own output dims (B/C/dt streams are small -> replicate)
    "in_proj": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_z": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_xin": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_b": [(-2, ("data",))],
    "w_c": [(-2, ("data",))],
    "w_dt": [(-1, (TP_AXIS,))],
    "conv_wx": [(-1, (TP_AXIS,))],
    "conv_bx": [(-1, (TP_AXIS,))],
    "out_proj": [(-2, (TP_AXIS,)), (-1, ("data",))],
    "w_x": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_gate_branch": [(-1, (TP_AXIS,)), (-2, ("data",))],
    "w_r": [(-1, (TP_AXIS,))],
    "w_i": [(-1, (TP_AXIS,))],
    "w_out": [(-2, (TP_AXIS,)), (-1, ("data",))],
    "conv_w": [(-1, (TP_AXIS,))],
    "conv_b": [(-1, (TP_AXIS,))],
    "router": [],
}

_MOE_PREFS = {
    # expert-parallel stacks [E, d, f] / [E, f, d]
    "w_gate": [(-3, (TP_AXIS,)), (-2, ("data",))],
    "w_up": [(-3, (TP_AXIS,)), (-2, ("data",))],
    "w_down": [(-3, (TP_AXIS,)), (-2, ("data",))],
}


def param_pspec(path, leaf, mesh_shape: dict) -> tuple:
    """The spec of a parameter leaf (anything with ``.shape``) at ``path``,
    the reference's key names (``("segments", "[0]", "attn", "wq")``)."""
    names = [str(k) for k in path]
    leaf_name = names[-1]
    in_moe = "moe" in names
    table = _MOE_PREFS if (in_moe and leaf_name in _MOE_PREFS) else _PARAM_PREFS
    prefs = table.get(leaf_name, [])
    nd = len(leaf.shape)
    prefs_abs = [(nd + d if d < 0 else d, a) for d, a in prefs
                 if -nd <= d < nd]
    return pick_spec(tuple(leaf.shape), prefs_abs, mesh_shape)


def _param_specs(named: dict, mesh_shape: dict) -> dict[str, tuple]:
    """Each parameter's spec: the reference's spec of its stacked leaf,
    less the stack's dim for a layer's tensor."""
    counts: dict[tuple, int] = {}
    for name in named:
        path, layer = reference_path(name)
        if layer is not None:
            counts[path] = max(counts.get(path, 0), layer + 1)
    specs = {}
    for name, t in named.items():
        path, layer = reference_path(name)
        if layer is None:
            specs[name] = param_pspec(path, t, mesh_shape)
            continue
        stacked = param_pspec(path, torch.empty(
            (counts[path], *t.shape), device="meta"), mesh_shape)
        if stacked[0] is not None:
            raise ValueError(f"{name}: the stacked spec {stacked} shards "
                             "the layer dim")
        specs[name] = stacked[1:]
    return specs


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)


def is_multi(mesh) -> bool:
    """True for a mesh of more than one rank."""
    return not isinstance(mesh, LocalMesh) and mesh.size() > 1


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """This rank's block of a tensor of ``shape`` split by ``spec`` (every
    split even: ``pick_spec`` only assigns axes that divide)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec or ()):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n = math.prod(sizes[a] for a in axes)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out[dim] //= n
    return tuple(out)


def place(t: torch.Tensor, sharding: NamedSharding,
          zeros: bool = False) -> torch.Tensor:
    """``t`` placed by ``sharding``.  On a mesh of one rank: ``t`` on the
    mesh's device.  On more: a ``DTensor`` of the spec's placements whose
    local block is this rank's slice of ``t`` on the mesh's device (``t``
    is the same on every rank; nothing moves between ranks), or, for a
    ``meta`` ``t``, a ``meta`` block, or a zero-filled one on the mesh's
    device when ``zeros``.  A DTensor ``t`` is redistributed."""
    mesh = sharding.mesh
    if not is_multi(mesh):
        return t.to(sharding.device)
    want = spec_placements(sharding.spec, mesh)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == want else t.redistribute(
            mesh, want)
    if t.is_meta:
        shape = local_shape(t.shape, sharding.spec, mesh)
        local = (torch.zeros(shape, dtype=t.dtype, device=sharding.device)
                 if zeros else torch.empty(shape, dtype=t.dtype,
                                           device="meta"))
        return DTensor.from_local(local, mesh, want, run_check=False,
                                  shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    out = distribute_tensor(t.to(sharding.device), mesh, want,
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.nbytes:
        # a block of dim 0 is a view of the whole tensor: keep only the block
        out = DTensor.from_local(local.clone(), mesh, want, run_check=False,
                                 shape=out.shape, stride=out.stride())
        out.requires_grad_(t.requires_grad)
    return out


def place_tree(tree, shardings, zeros: bool = False):
    """:func:`place` over matching dicts / lists of tensors and
    shardings (None, or a tensor with no sharding, passes through)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k], zeros)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s, zeros)
                          for v, s in zip(tree, shardings))
    if tree is None or shardings is None:
        return tree
    return place(tree, shardings, zeros)


@torch.no_grad()
def distribute_params(module: nn.Module, mesh,
                      zeros: bool = False) -> nn.Module:
    """Replace each parameter of ``module`` (an ``LM``) by its
    :func:`place` under :func:`param_shardings`, in place; returns
    ``module``.  On one rank the parameters only move to the mesh's
    device."""
    shardings = param_shardings(module, mesh)
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(place(p.detach(), shardings[name],
                                              zeros),
                                        requires_grad=p.requires_grad))
    return module


def param_shardings(abstract_tree, mesh):
    """A :class:`NamedSharding` a parameter name of ``abstract_tree`` (an
    ``LM``, or a name -> tensor mapping such as the optimizer's ``m``);
    None for None."""
    if abstract_tree is None:
        return None
    if isinstance(abstract_tree, nn.Module):
        abstract_tree = dict(abstract_tree.named_parameters())
    specs = _param_specs(abstract_tree, mesh_axes(mesh))
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def batch_pspec(shape: tuple[int, ...], mesh_shape: dict) -> tuple:
    """Token/label/embeds batches: batch over (pod, data)."""
    prefs = [(0, DP_AXES), (0, ("data",))]
    return pick_spec(shape, prefs, mesh_shape)


def batch_shardings(batch_tree: dict, mesh) -> dict:
    mesh_shape = mesh_axes(mesh)
    return {k: NamedSharding(mesh, batch_pspec(tuple(v.shape), mesh_shape))
            for k, v in batch_tree.items()}


def cache_pspec(shape: tuple[int, ...], mesh_shape: dict,
                seq_axis_joint: bool = False) -> tuple:
    """Decode caches.

    KV tensors are [count, B, L, hkv, hd]; ssm/rglru states are
    [count, B, ...].  Batch gets (pod, data) when divisible; the longest
    remaining dim gets `model` (KV length / state width).
    """
    nd = len(shape)
    prefs: list[tuple[int, tuple[str, ...]]] = []
    if nd >= 2:
        prefs.append((1, DP_AXES))
        prefs.append((1, ("data",)))
    if nd >= 3:
        # the sequence / width dim: prefer the largest dim after batch
        cand = int(np.argmax(shape[2:])) + 2
        if seq_axis_joint:
            prefs.append((cand, (TP_AXIS, "data")))
        prefs.append((cand, (TP_AXIS,)))
    return pick_spec(shape, prefs, mesh_shape)


def cache_shardings(cache_tree: list, mesh, seq_axis_joint: bool = False
                    ) -> list:
    """One dict of :class:`NamedSharding` a segment, as the caches."""
    mesh_shape = mesh_axes(mesh)
    return [{k: NamedSharding(mesh, cache_pspec(tuple(v.shape), mesh_shape,
                                                seq_axis_joint))
             for k, v in seg.items()} for seg in cache_tree]


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
