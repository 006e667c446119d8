"""Device meshes over ``torch.distributed`` (the port's counterpart of
``repro.compat.make_mesh`` and ``repro.launch.mesh``).

The reference drives every device of a ``jax.sharding.Mesh`` from one
process; the port runs one process per rank, each holding its own blocks,
and the collectives run on the mesh's process groups.  Rank order is the
mesh's row-major order, which is the reference's flat shard index
``((pod*D)+data)*M + model``.

The process group is the caller's: start one with
``torch.distributed.init_process_group`` (NCCL for a CUDA mesh, gloo for
a CPU mesh) before :func:`make_mesh`, which never starts one itself.
:func:`make_production_mesh` is the one exception: the dry-run's 256- or
512-rank mesh over a *fake* process group, run by one process as rank 0.

:func:`use_mesh` makes a mesh ambient for the code it wraps, and
:func:`get_abstract_mesh` reads it (None outside), as
``repro.compat.use_mesh`` / ``get_abstract_mesh`` do for the reference's
model code: the MoE layer's expert parallelism and
``models.psharding.tp_size`` read it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_AMBIENT = contextvars.ContextVar("ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_abstract_mesh() -> DeviceMesh | None:
    """The ambient mesh of :func:`use_mesh`, None outside one."""
    return _AMBIENT.get()


def make_mesh(axis_shapes, axis_names, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    process group already initialised, whose world size must equal the
    mesh's size.

    ``device=None`` means this rank's CUDA card (``cuda:rank % count``)
    and needs an NCCL group; ``device="cpu"`` needs a gloo group."""
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"axis_shapes {axis_shapes} and axis_names "
                         f"{axis_names} differ in length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialised: call torch.distributed."
            "init_process_group(backend, init_method='tcp://localhost:"
            "<port>' or 'file://<path>', world_size=N, rank=r) on every "
            "rank first (nccl for a CUDA mesh, gloo for a CPU mesh)")
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)            # raises: no card
        dev_type = "cuda"
    else:
        dev_type = torch.device(device).type
    if dev_type not in _BACKEND:
        raise ValueError(f"unsupported mesh device {device!r} (cuda or cpu)")
    backend = dist.get_backend()
    if backend != _BACKEND[dev_type]:
        raise ValueError(f"a {dev_type} mesh needs a {_BACKEND[dev_type]} "
                         f"process group, this one is {backend}")
    world = dist.get_world_size()
    if math.prod(axis_shapes) != world:
        raise ValueError(f"mesh {axis_shapes} holds {math.prod(axis_shapes)}"
                         f" ranks, the process group {world}")
    if dev_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev_type, axis_shapes,
                            mesh_dim_names=axis_names)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod`` (the
    reference's production meshes), over a fake process group in which
    this process is rank 0: every collective runs without peers and
    moves no data, so one process runs one rank's step programs at the
    production shard counts (the dry-run).

    Starts the fake group itself when none is started; a started group
    must be a fake one of the mesh's size.  ``device=None`` means the CUDA
    card (raising without one), ``"cpu"`` the CPU."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    world = math.prod(shape)
    dev_type = resolve_device(device).type
    if not dist.is_initialized():
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_backend() != "fake" or dist.get_world_size() != world:
        raise ValueError(f"the production mesh needs a fake process group "
                         f"of {world} ranks, this one is "
                         f"{dist.get_backend()} of {dist.get_world_size()}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Number of ranks along ``axes`` (one name or a tuple of names)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def flat_axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's row-major index over ``axes`` (the reference's
    ``_flat_axis_index``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def axes_group(mesh: DeviceMesh, axes):
    """The process group over ``axes`` flattened, its ranks in row-major
    order over them: one axis is the mesh's own group of that axis, every
    axis the whole mesh's group.  Otherwise the groups of every fixed
    position on the other axes are created (a collective call: every rank
    makes it, in the same order) and this rank's is returned.  ``axes``
    must follow the mesh's axis order, so that the group's rank order is
    the flat index."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    pos = [names.index(a) for a in axes]
    if pos != sorted(pos) or len(set(pos)) != len(pos):
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if len(axes) == len(names):
        return dist.group.WORLD
    ranks = mesh.mesh                       # int tensor of the mesh's shape
    others = [i for i in range(len(names)) if i not in pos]
    grid = ranks.permute(*others, *pos).reshape(
        math.prod(ranks.shape[i] for i in others), -1)
    mine = None
    for row in grid.tolist():
        group = dist.new_group(ranks=row)
        if dist.get_rank() in row:
            mine = group
    return mine
