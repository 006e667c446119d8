"""Logical activation-sharding rules (port of ``repro.models.psharding``).

The reference annotates activations with *logical* axis names and
``constrain`` maps them onto the ambient mesh's axes for XLA's sharding
propagation.  The port's sharded tensors are ``DTensor``s (PyTorch's SPMD
tensor, the counterpart of a GSPMD array): on a mesh of more than one
rank ``constrain`` redistributes a DTensor to the placements of
``spec_for``'s spec, as the reference's ``with_sharding_constraint``
does (dims the spec leaves out are replicated, a pending partial sum is
reduced).  A plain tensor, or any tensor on one rank, passes through
unchanged, so every single-rank path computes what it computed before.
``RULES`` and ``spec_for`` keep the reference's arithmetic;
:func:`placements` turns a spec into DTensor placements, and
``tp_size`` reads a DTensor's mesh or the ambient one
(``launch.mesh.use_mesh``).  The rest runs a model's op on each rank's
blocks where DTensor's own rules would choose a layout badly or have
none: :func:`einsum` (the weight products), :func:`local_map` (with the
gradients' placements), :func:`pointwise` and :func:`along_seq`.
"""
from __future__ import annotations

import functools
import math
from collections.abc import Mapping

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map as _local_map

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


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` (``PartitionSpec`` entries, or None
    for a replicated tensor) on a ``DeviceMesh``: one a mesh dim,
    ``Shard(dim)`` on each mesh axis a dim names, ``Replicate()`` on the
    others.  A dim over several axes, ``("pod", "data")``, is split over
    them major to minor, JAX's order, which is DTensor's when the axes
    follow the mesh's order; any other order raises.  A mesh dim of one
    rank is always ``Replicate()``: a split into one block is none, and
    DTensor's search over layouts grows with every Shard it sees."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec or ()):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} does not follow the "
                             f"mesh's axis order {names}")
        for i in pos:
            if mesh.size(i) == 1:
                continue                # one rank: Shard and Replicate agree
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]} "
                                 "twice")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding hint: a DTensor on a mesh of more than
    one rank is redistributed to ``spec_for``'s placements; anything
    else is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    # the DTensor's own mesh is the ambient one, which autograd's device
    # threads (where a checkpointed layer is recomputed) do not see
    mesh = x.device_mesh
    if mesh.size() == 1:
        return x
    want = placements(spec_for(tuple(x.shape), logical, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def shard_like(t: torch.Tensor, ref: torch.Tensor, dims: dict):
    """``t`` (a plain tensor, the same on every rank) as a DTensor on
    ``ref``'s mesh: ``t``'s dim ``dims[d]`` split as ``ref``'s dim ``d``
    is, every other mesh dim replicated.  Each rank keeps its own slice,
    so nothing moves; a plain ``ref`` gives ``t`` back.  For the index
    and mask tensors a sharded op compares against its operand."""
    if not isinstance(ref, DTensor):
        return t
    nd = ref.ndim
    want = []
    for p in ref.placements:
        d = p.dim % nd if isinstance(p, Shard) else None
        want.append(Shard(dims[d]) if d in dims else Replicate())
    return distribute_tensor(t, ref.device_mesh, want, src_data_rank=None)


def local_map(fn, out_placements, in_placements, mesh):
    """``fn`` run on the local blocks of its DTensor arguments, each
    first redistributed to its entry of ``in_placements`` (the
    collectives DTensor needs for that); its outputs are DTensors of
    ``out_placements`` (one tuple of placements an output).  Plain
    tensor arguments pass as they are.

    Gradients: an input replicated over a mesh dim on which anything
    else is split or partial was used differently by each rank there, so
    its gradient is a partial sum over that dim (declared so to
    ``local_map``); over a dim on which everything is replicated the
    ranks computed alike and it stays replicated."""
    every = [pl for pl in (*in_placements, *out_placements) if pl]
    split = {i for pl in every for i, q in enumerate(pl)
             if not isinstance(q, Replicate)}
    grads = tuple(None if pl is None else tuple(
        Partial() if isinstance(q, Replicate) and i in split else q
        for i, q in enumerate(pl)) for pl in in_placements)
    return _local_map(fn, out_placements=out_placements,
                      in_placements=in_placements, in_grad_placements=grads,
                      device_mesh=mesh, redistribute_inputs=True)


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; a DTensor's blocks each take
    it (``local_map``, a pending partial sum reduced first), for the
    elementwise ops some torch versions give DTensor no rule for
    (``softplus``)."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    return local_map(fn, (pl,), (pl,), x.device_mesh)(x)


def along_seq(fn, xs: tuple, per_channel: tuple) -> torch.Tensor:
    """``fn(*xs, *per_channel)`` for ``xs`` [B, S, C] DTensors and
    ``per_channel`` weights [..., C], an ``fn`` that mixes positions
    along S (a causal conv, a scan) and never channels: on each rank's
    blocks (``local_map``), the batch and channel splits of ``xs[0]``
    kept, S whole, the weights split as the channels (for ops, such as
    a padding of S, that some torch versions give DTensor a broken
    rule for)."""
    x_pl = tuple(q if isinstance(q, Shard) and q.dim % 3 in (0, 2)
                 else Replicate() for q in xs[0].placements)
    w_pl = [tuple(Shard(w.ndim - 1) if isinstance(q, Shard) and
                  q.dim % 3 == 2 else Replicate() for q in x_pl)
            for w in per_channel]
    return local_map(fn, (x_pl,), (x_pl,) * len(xs) + tuple(w_pl),
                     xs[0].device_mesh)(*xs, *per_channel)


def _letters(eq: str, ndims: tuple[int, ...]) -> tuple[list[str], str]:
    """The operands' and the output's index letters of ``eq``, a leading
    ``...`` spelled out in upper-case letters."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    n = max((nd - len(t.replace("...", "")) for t, nd in zip(ins, ndims)
             if "..." in t), default=0)
    fill = "ABCDEFGH"[:n]
    return [t.replace("...", fill) for t in ins], out.replace("...", fill)


def einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w``.  On DTensors it runs on each rank's blocks (``local_map``) in
    the layout the reference's GSPMD takes for a sharded projection,
    chosen a mesh dim at a time: on ``model`` the weight keeps its split
    and the activation moves (gathered where the weight splits an output
    index, split alike where it splits the contracted one: a partial
    sum out, the tensor-parallel pair); on the data axes the activation
    keeps its batch split and the weight's FSDP split is gathered.  An
    index both operands and the output carry is split alike.  (Left to
    choose, DTensor flattens the weight's split index with its unsplit
    neighbours and cannot unflatten the product.)"""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return torch.einsum(eq, x, w)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    (xs, ws), os_ = _letters(eq, (x.ndim, w.ndim))

    def letter(t, spec, i):
        if not isinstance(t, DTensor):
            return None
        q = t.placements[i]
        return spec[q.dim % t.ndim] if isinstance(q, Shard) else None

    x_pl, w_pl, o_pl = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        xl, wl = letter(x, xs, i), letter(w, ws, i)
        rules = []
        for lt in (xl, wl):
            if lt and lt in xs and lt in ws and lt in os_:
                rules.append((lt, lt, lt))           # shared: split alike
        w_rules = ([(None, wl, wl)] if wl and wl in os_ and wl not in xs
                   else []) + ([(wl, wl, "+")] if wl and wl not in os_
                               and wl in xs else [])
        x_rules = ([(xl, None, xl)] if xl and xl in os_ and xl not in ws
                   else []) + ([(xl, xl, "+")] if xl and xl not in os_
                               and xl in ws else [])
        rules += (w_rules + x_rules) if name == "model" else \
            (x_rules + w_rules)
        xr, wr, orr = rules[0] if rules else (None, None, None)
        x_pl.append(Shard(xs.index(xr)) if xr else Replicate())
        w_pl.append(Shard(ws.index(wr)) if wr else Replicate())
        o_pl.append(Partial() if orr == "+" else
                    (Shard(os_.index(orr)) if orr else Replicate()))
    fn = local_map(functools.partial(torch.einsum, eq), (tuple(o_pl),),
                   (tuple(x_pl), tuple(w_pl)), mesh)
    return fn(x, w)


def tp_size(like: torch.Tensor | None = None) -> int:
    """Size of the tensor-parallel ('model') axis of ``like``'s mesh when
    it is a DTensor, else of the ambient mesh (1 if no ambient mesh)."""
    mesh = like.device_mesh if isinstance(like, DTensor) else \
        get_abstract_mesh()
    if mesh is None:
        return 1
    return mesh_axes(mesh).get("model", 1)
