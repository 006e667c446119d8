"""Logical activation-sharding rules (port of ``repro.models.psharding``).

The reference annotates activations with *logical* axis names and
``constrain`` maps them onto the ambient mesh's axes for XLA's sharding
propagation.  In the port every rank holds its own tensors and no
compiler places them, so ``constrain`` has nothing to constrain and
returns its input; ``RULES`` and ``spec_for`` keep the reference's
arithmetic (which mesh axes a dim of a given size would shard over), and
``tp_size`` reads the ambient mesh of ``launch.mesh.use_mesh``.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch

from repro_torch.launch.mesh import get_abstract_mesh

# logical axis -> preferred mesh axes (first-fit with divisibility)
RULES: dict[str | None, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),   # GQA fallback when heads % model != 0
    "ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),     # decode: shard the KV length (flash-decode)
    "q_seq": ("model",),      # misaligned-head attention: shard q rows
    "q_chunks": ("model",),   # flash: shard the q-chunk grid dim
    "seq": (),                # sequence stays unsharded in the baseline
    "embed": (),
    "state": (),
    None: (),
}


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh: any object with ``axis_names`` and a
    ``shape`` mapping (the reference's meshes), or a ``DeviceMesh``
    (``mesh_dim_names`` and a ``shape`` tuple)."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names or ()
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


def spec_for(shape: tuple[int, ...], logical: tuple[str | None, ...],
             mesh) -> tuple | None:
    """The reference's ``PartitionSpec`` entries for ``shape`` as a tuple
    (a mesh axis name, a tuple of names, or None per dim), or None when
    no dim shards."""
    sizes = mesh_axes(mesh)
    entries: list = []
    used: set[str] = set()
    for dim in range(len(shape)):
        name = logical[dim] if dim < len(logical) else None
        axes = tuple(a for a in RULES.get(name, ())
                     if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and shape[dim] % size == 0 and size > 1:
            entries.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            # try a shorter prefix (e.g. batch=("pod","data") -> ("data",))
            hit = None
            for a in axes:
                if shape[dim] % sizes[a] == 0 and sizes[a] > 1:
                    hit = a
                    break
            entries.append(hit)
            if hit:
                used.add(hit)
    if all(e is None for e in entries):
        return None
    return tuple(entries)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding hint: ``x`` unchanged (see the module
    docstring)."""
    return x


def tp_size() -> int:
    """Size of the ambient mesh's tensor-parallel ('model') axis (1 if no
    ambient mesh)."""
    mesh = get_abstract_mesh()
    if mesh is None:
        return 1
    return mesh_axes(mesh).get("model", 1)
