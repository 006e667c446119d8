"""Loop-aware FLOP / byte / collective counts of an eager step program:
the port's counterpart of ``repro.launch.hlo_analysis``.

Eager PyTorch leaves no HLO to parse, so the program is counted while it
runs, under a ``TorchDispatchMode``::

    with StepAnalysis() as a:
        step(...)
    a.result()   # {flops, bytes, collective_bytes, collective_count,
                 #  collective_by_op}: analyze_hlo_text's dict

``launch.roofline.roofline_terms`` takes the result unchanged.  The rules
are the reference's:

* **FLOPs**: the matmul and convolution family (and attention) by the
  formulas of ``torch.utils.flop_counter``'s registry, as the reference
  counts dot and convolution.  Every op in :data:`ZERO_FLOP_OPS` counts
  none; any other op raises ``NotImplementedError`` naming it, so no op
  is swallowed uncounted.
* **Bytes**: each op's tensor inputs read once and its outputs written
  once (an in-place op reads and writes its operand; ``copy_``'s
  destination and ``out=`` buffers are written only).  An op
  whose output aliases an input (a view, reshape, expand or slice) moves
  none, nor does an allocation that writes nothing (``empty``).  A copy
  between the host and the card (``.cpu()``, ``.to()``, ``.item()``) is
  not HBM traffic of the step and counts none, nor does a copy of a
  value the host made (``torch.tensor(...)``, ``x[i] = 0``), which the
  card takes from the host and the CPU from its own memory: so a program
  counts the same on both.
* **Collectives**: each ``c10d`` op counts its input bytes per rank under
  the reference's kind (``all-to-all``, ``all-reduce``, ``all-gather``,
  ``reduce-scatter``: the ones the port runs) and its call once; its
  input and output buffers count as bytes, as the reference counts a
  collective's operands and results.  Any other ``c10d`` op raises.
* **Sharded programs**: a step on ``DTensor``s (``launch.shardings``)
  is counted at this rank's shapes.  The mode declines every op whose
  operands are DTensors (it returns ``NotImplemented``), so DTensor runs
  it and the mode sees the local ops DTensor issues on the rank's
  blocks, with the rules above; the ops DTensor runs on its own
  ``FakeTensor``s to propagate shapes move nothing and are not counted.
  The functional collectives DTensor issues to redistribute count as
  the reference's kinds (``all_gather_into_tensor`` as all-gather,
  ``reduce_scatter_tensor`` as reduce-scatter, ``all_reduce`` as
  all-reduce, ``all_to_all_single`` and DTensor's own
  ``shard_dim_alltoall`` as all-to-all), each at its input bytes per
  rank, and ``wait_tensor`` (or the autograd wrapper of a result)
  counts nothing.  ``meta`` tensors (the dry-run's stand-ins) count by
  their shapes, as real ones do.
  Two limits: DTensor picks its own collectives (on a CPU mesh it runs
  an all-to-all as an all-gather), so the collective bytes are this
  port's, not GSPMD's; and bytes are counted at eager op boundaries,
  where XLA counts fused kernels, so the port's bytes exceed the
  reference's for the same program.
* **Loops**: eager execution runs every iteration, so every iteration
  counts: the reference's trip-count rule without a parser.
* **Kernel calls**: a wrapper in ``repro_torch.kernels`` reports its call
  (:meth:`StepAnalysis.kernel_call`), one op at the bytes its bound counts
  (each input read once, each output written once, as the run's data
  needs) and, for K6 and K7, its FLOPs.  The aten ops inside the call are
  not counted: on the CPU they are the wrapper's plain body, on the card
  its allocations (the launch itself is invisible to the mode).  So one
  program counts the same on the CPU (``use_kernels=True``) and on the
  card.

Shapes are this rank's, so every count is per device, as the reference's
are for an SPMD module.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _report

# Ops counted at zero FLOPs: every op the port's programs run that is
# neither a dot nor a convolution nor a view (elementwise, compare,
# reduce, scan, sort, search, gather/scatter, index, copy, fill, factory;
# the second block: the LM steps' forward and backward ops).
ZERO_FLOP_OPS = frozenset(f"aten.{n}" for n in """
    __lshift__ __rshift__ _local_scalar_dense _to_copy add any arange
    bitwise_and bitwise_and_ bitwise_not bitwise_or cat clamp clamp_ clone
    constant_pad_nd copy_ cumsum div empty empty_like eq floor_divide full
    full_like gather ge gt index index_put_ lt masked_fill_ minimum mul ne
    neg ones remainder scalar_tensor scatter_ scatter_reduce_ searchsorted
    sort stack sub sum where zeros zeros_like
    _softmax _softmax_backward_data add_ amax argmax argsort cos detach_
    div_ exp flip gelu gelu_backward index_add index_put index_select le
    log maximum mean mul_ new_zeros nonzero ones_like pow reciprocal rsqrt
    rsub scatter select_backward sigmoid sigmoid_backward silu
    silu_backward sin slice_backward softplus softplus_backward sqrt sqrt_
    sub_ tril
""".split())

_VIEWS = frozenset({"aten._unsafe_view"})      # views outside is_view
_HOST = frozenset({"aten._local_scalar_dense"})
_ALLOC = frozenset({"aten.empty", "aten.empty_like"})
_MOVES = frozenset({"aten._to_copy", "aten.copy_"})

# c10d op the port's programs run -> (the reference's kind, its input
# argument, its output argument)
COLLECTIVES = {
    "c10d.alltoall_base_": ("all-to-all", "input", "output"),
    "c10d.allreduce_": ("all-reduce", "tensors", "tensors"),
    "c10d.allgather_": ("all-gather", "input_tensors", "output_tensors"),
    # the functional collectives DTensor issues; None: the op's result
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "input",
                                                None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "input",
                                               None),
    "_c10d_functional.all_reduce": ("all-reduce", "input", None),
    "_c10d_functional.all_to_all_single": ("all-to-all", "input", None),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "input", None),
}
# waits and autograd wrappers of a collective's result: no data moves
_WAIT = frozenset({"_c10d_functional.wait_tensor",
                   "_c10d_functional._wrap_tensor_autograd"})


def _nbytes(values) -> int:
    """Bytes of the distinct tensors among ``values`` (nested lists too)."""
    seen, total = set(), 0
    for t in tree_leaves(values):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _named_args(func, args, kwargs) -> list:
    """(schema argument, value) for every argument given."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if i < len(args):
            out.append((a, args[i]))
        elif a.name in kwargs:
            out.append((a, kwargs[a.name]))
    return out


def _devices(values) -> set:
    return {t.device for t in tree_leaves(values)
            if isinstance(t, torch.Tensor)}


class StepAnalysis(TorchDispatchMode):
    """Counts the program run inside ``with StepAnalysis() as a:`` (one
    analysis at a time).  ``a.result()`` gives the reference's five keys;
    ``a.kernels`` maps each reported kernel to its calls, bytes and
    FLOPs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_count = 0
        self.collective_by_op: dict = {}
        self.kernels: dict = {}
        self._paused = 0
        self._host: dict = {}      # id -> tensor made from a host value

    def __enter__(self):
        if _report.active is not None:
            raise RuntimeError("a StepAnalysis is already counting")
        _report.active = self
        try:
            return super().__enter__()
        except BaseException:
            _report.active = None
            raise

    def __exit__(self, *exc):
        _report.active = None
        return super().__exit__(*exc)

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collective_count": self.collective_count,
                "collective_by_op": dict(self.collective_by_op)}

    def kernel_call(self, name: str, cost, fn, *args, **kwargs):
        """Run kernel wrapper ``fn(*args, **kwargs)`` as one counted op:
        ``cost()`` gives its (bytes, flops) from its inputs, which no
        wrapper writes.  Neither ``cost`` nor the call is counted op by
        op, and a wrapper reached inside the call does not report
        again."""
        _report.active = None
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
            nbytes, flops = cost()
        finally:
            self._paused -= 1
            _report.active = self
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                           "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        self.bytes += nbytes
        self.flops += flops
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented         # DTensor runs it: its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused and not any(
                isinstance(t, FakeTensor)
                for t in tree_leaves((args, kwargs, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        if name in _WAIT:
            return
        if func.namespace in ("c10d", "_c10d_functional", "_dtensor"):
            self._collective(name, func, args, kwargs, out)
            return
        if name == "aten.lift_fresh":
            self._host[id(out)] = out               # kept: ids stay unique
        if func.is_view or name in _VIEWS:
            return                                  # no FLOPs, no bytes
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif name not in ZERO_FLOP_OPS:
            raise NotImplementedError(
                f"StepAnalysis has no rule for {func}: add it to "
                "ZERO_FLOP_OPS if it does no dot or convolution")
        if name in _HOST | _ALLOC:
            return
        named = _named_args(func, args, kwargs)
        if name in _MOVES:
            src = args[0] if name == "aten._to_copy" else args[1]
            if id(src) in self._host or len(
                    _devices([v for _, v in named]) | _devices(out)) > 1:
                return                              # host <-> card
        reads = []
        for a, v in named:
            written = a.alias_info is not None and a.alias_info.is_write
            if written and (a.kwarg_only or name == "aten.copy_"):
                continue
            reads.append(v)
        self.bytes += _nbytes(reads) + _nbytes(out)

    def _collective(self, name: str, func, args, kwargs, out) -> None:
        if name not in COLLECTIVES:
            raise NotImplementedError(f"StepAnalysis has no rule for {func}")
        kind, src, dst = COLLECTIVES[name]
        given = {a.name: v for a, v in _named_args(func, args, kwargs)}
        nin = _nbytes(given[src])
        self.collective_bytes += nin
        self.collective_count += 1
        self.collective_by_op[kind] = self.collective_by_op.get(kind, 0.0) \
            + nin
        self.bytes += nin + _nbytes(out if dst is None else given[dst])
