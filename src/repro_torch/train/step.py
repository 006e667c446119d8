"""Train / serve step builders with mesh shardings (port of
``repro.train.step``).

``build_train_step`` returns an eager (state, batch) -> (state, metrics)
with param/optimizer shardings from ``launch.shardings``;
``build_serve_step`` returns (params, caches, tokens, pos) -> (logits,
caches).  The state is ``{"params": LM, "opt": {"m", "v", "step"}}``
(``optim.adamw``); a step updates it in place, the counterpart of the
reference's ``donate_argnums=(0,)``, and returns it.

On a mesh of more than one rank the state, batch and caches are
``DTensor``s placed by their shardings (``launch.shardings.place_tree``,
``distribute_params``), and a step runs the model on them: each op runs
on this rank's blocks and DTensor issues the collectives its sharding
rules need, steered by the models' ``psharding.constrain`` hints as GSPMD
is by the reference's.  Inside a step a plain tensor (a mask, an index,
a position) counts as replicated (``implicit_replication``).  The
microbatches are the reference's: microbatch i is the global batch's
rows ``[i*m, (i+1)*m)``, re-pinned to the data axes by one all-to-all of
the batch (:func:`_sharded_microbatches`), so no rank ever holds the
global batch.  On one rank nothing of this runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import use_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (abstract_params, init_params,
                                            loss_fn, prefill_step,
                                            serve_step)
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    grad_compress: bool = False
    # gradient-accumulation microbatches: bounds the live activation set to
    # one microbatch (the per-device HBM-fit knob at 4k x 256 batches)
    microbatches: int = 1


def _value_and_grad(params, cfg: ArchConfig, batch: dict, leaves):
    """(loss, metrics, grads): ``loss_fn`` and its gradient for every
    tensor of ``leaves`` (zeros where it does not reach), in their
    dtypes."""
    loss, metrics = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    # a sharded parameter's gradient may come back partial or laid out
    # otherwise: give it the parameter's placements (a reduce-scatter at
    # most), as the reference's out_shardings do
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) and g.placements != p.placements
             else g for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, grads


def _sharded_microbatches(v: DTensor, nm: int) -> list[DTensor]:
    """The reference's microbatches of a batch DTensor: microbatch i is
    the global rows ``[i*m, (i+1)*m)`` (m = B / nm), split over the same
    mesh dims as ``v`` (its dim 0, over the data axes, is all ``v``
    splits).  With blocks of mD = m / D rows (D ranks on dim 0), global
    block k lies whole on rank k // nm and goes to rank k % D as its
    share of microbatch k // D: one all-to-all over the data group moves
    every rank's nm blocks, after which each rank's i-th block is its
    share of microbatch i."""
    mesh = v.device_mesh
    b_glob = v.shape[0]
    m = b_glob // nm
    dims = [i for i, p in enumerate(v.placements) if isinstance(p, Shard)]
    if any(v.placements[i].dim != 0 for i in dims):
        raise ValueError(f"a batch split on another dim than 0: "
                         f"{v.placements}")
    d = math.prod(mesh.size(i) for i in dims)
    local = v.to_local()
    if d == 1:
        return [DTensor.from_local(local[i * m:(i + 1) * m], mesh,
                                   v.placements, run_check=False)
                for i in range(nm)]
    if m % d:
        raise ValueError(f"microbatches of {m} rows do not split over "
                         f"{d} data ranks")
    md = m // d
    names = [mesh.mesh_dim_names[i] for i in dims]
    flat = mesh[tuple(names)]
    if len(names) > 1:
        flat = flat._flatten()         # ranks in row-major order: DTensor's
    group, r = flat.get_group(), flat.get_local_rank()
    dest = [(r * nm + j) % d for j in range(nm)]
    order = sorted(range(nm), key=lambda j: dest[j])      # stable
    send = local.reshape(nm, md, *local.shape[1:])[order].reshape(
        local.shape)
    in_splits = [md * dest.count(q) for q in range(d)]
    out_splits = [md * sum((s * nm + j) % d == r for j in range(nm))
                  for s in range(d)]
    recv = funcol.all_to_all_single(send, out_splits, in_splits, group)
    recv = funcol.wait_tensor(recv).reshape(nm, md, *local.shape[1:])
    shape = (m, *v.shape[1:])
    return [DTensor.from_local(recv[i], mesh, v.placements, run_check=False,
                               shape=shape,
                               stride=torch.empty(shape,
                                                  device="meta").stride())
            for i in range(nm)]


def _microbatches(batch: dict, nm: int) -> list[dict]:
    """The batch's nm microbatches along its first dim (a sharded batch by
    :func:`_sharded_microbatches`)."""
    parts = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            parts[k] = _sharded_microbatches(v, nm)
        else:
            parts[k] = [v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                        for i in range(nm)]
    return [{k: parts[k][i] for k in batch} for i in range(nm)]


def accumulate_grads(params, cfg: ArchConfig, batch: dict,
                     microbatches: int = 1):
    """(loss, metrics, grads keyed by parameter name) of ``loss_fn`` on
    ``batch``.  With ``microbatches`` nm > 1 the batch is split into nm
    equal parts along its first dim; their grads are summed in float32
    and divided by nm, the loss and metrics are their means, as the
    reference's scan does."""
    named = dict(params.named_parameters())
    names, leaves = list(named), list(named.values())
    nm = microbatches
    if nm == 1:
        loss, metrics, g = _value_and_grad(params, cfg, batch, leaves)
        return loss, metrics, dict(zip(names, g))
    gsum = {k: (torch.zeros_like(p, dtype=torch.float32)
                if isinstance(p, DTensor) else
                torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            for k, p in named.items()}
    losses, metrics_all = [], []
    for mb in _microbatches(batch, nm):
        loss, metrics, g = _value_and_grad(params, cfg, mb, leaves)
        for k, gi in zip(names, g):
            gsum[k].add_(gi)
        del g
        losses.append(loss)
        metrics_all.append(metrics)
    grads = {k: g.div_(nm) for k, g in gsum.items()}
    loss = torch.stack(losses).mean()
    metrics = {k: torch.stack([m[k] for m in metrics_all]).mean()
               for k in metrics_all[0]}
    return loss, metrics, grads


def train_step_fn(cfg: ArchConfig, tcfg: TrainConfig, state: dict,
                  batch: dict):
    """One optimizer step on ``batch`` (tensors on the parameters'
    device): :func:`accumulate_grads` over ``tcfg.microbatches``, then
    AdamW."""
    params = state["params"]
    loss, metrics, grads = accumulate_grads(params, cfg, batch,
                                            tcfg.microbatches)
    if tcfg.grad_compress:
        from repro_torch.train import compress
        gen = compress.generator_for(int(state["opt"]["step"]),
                                     loss.device)
        q, s = compress.compress_tree(grads, gen)
        grads = compress.decompress_tree(q, s)
    params, new_opt, opt_metrics = adamw.apply_updates(
        params, grads, state["opt"], tcfg.optimizer)
    metrics = dict(metrics, **opt_metrics, total_loss=loss)
    return {"params": params, "opt": new_opt}, metrics


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     dtype=torch.bfloat16) -> dict:
    """Random weights from ``generator`` (on its device) and a zero
    optimizer state."""
    params = init_params(cfg, generator, dtype)
    return {"params": params, "opt": adamw.init_state(params)}


def abstract_train_state(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The train state's shapes and dtypes on the ``meta`` device."""
    params = abstract_params(cfg, dtype)
    return {"params": params, "opt": adamw.init_state(params)}


def state_shardings(abstract_state: dict, mesh) -> dict:
    """Params + optimizer m/v share specs; step is replicated."""
    return {
        "params": sh.param_shardings(abstract_state["params"], mesh),
        "opt": {
            "m": sh.param_shardings(abstract_state["opt"]["m"], mesh),
            "v": sh.param_shardings(abstract_state["opt"]["v"], mesh),
            "step": sh.replicated(mesh),
        },
    }


@contextlib.contextmanager
def sharded_scope(mesh):
    """``mesh`` ambient; on more than one rank plain tensors also count
    as replicated DTensors."""
    with use_mesh(mesh):
        if sh.is_multi(mesh):
            with implicit_replication():
                yield
        else:
            yield


def build_train_step(cfg: ArchConfig, mesh, tcfg: TrainConfig | None = None,
                     abstract_state=None, abstract_batch=None):
    """Returns (fn, state_shardings, batch_shardings)."""
    tcfg = tcfg or TrainConfig()
    abstract_state = abstract_state or abstract_train_state(cfg)
    st_sh = state_shardings(abstract_state, mesh)
    b_sh = (sh.batch_shardings(abstract_batch, mesh)
            if abstract_batch is not None else None)

    def fn(state, batch):
        with sharded_scope(mesh):
            return train_step_fn(cfg, tcfg, state, batch)

    return fn, st_sh, b_sh


def build_prefill_step(cfg: ArchConfig, mesh, abstract_params=None,
                       abstract_batch=None):
    """Returns (fn, param_shardings, batch_shardings)."""
    p_sh = sh.param_shardings(abstract_params, mesh)
    b_sh = (sh.batch_shardings(abstract_batch, mesh)
            if abstract_batch is not None else None)

    @torch.no_grad()
    def fn(params, batch):
        with sharded_scope(mesh):
            return prefill_step(params, cfg, batch)

    return fn, p_sh, b_sh


def build_serve_step(cfg: ArchConfig, mesh, abstract_params=None,
                     abstract_caches=None, abstract_tokens=None,
                     seq_axis_joint: bool = False):
    """Returns (fn, param_shardings, cache_shardings).  ``fn`` takes the
    tokens where the caller put them; ``abstract_tokens`` is accepted for
    the reference's signature."""
    p_sh = sh.param_shardings(abstract_params, mesh)
    c_sh = (sh.cache_shardings(abstract_caches, mesh,
                               seq_axis_joint=seq_axis_joint)
            if abstract_caches is not None else None)

    @torch.no_grad()
    def fn(params, caches, tokens, pos):
        with sharded_scope(mesh):
            logits, caches = serve_step(params, cfg, caches, tokens, pos)
            if c_sh is not None and sh.is_multi(mesh):
                # the reference's out_shardings: the caches keep their spec
                caches = sh.place_tree(caches, c_sh)
            return logits, caches

    return fn, p_sh, c_sh
