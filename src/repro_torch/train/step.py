"""Train / serve step builders with mesh shardings (port of
``repro.train.step``).

``build_train_step`` returns an eager (state, batch) -> (state, metrics)
with param/optimizer shardings from ``launch.shardings``;
``build_serve_step`` returns (params, caches, tokens, pos) -> (logits,
caches).  The state is ``{"params": LM, "opt": {"m", "v", "step"}}``
(``optim.adamw``); a step updates it in place, the counterpart of the
reference's ``donate_argnums=(0,)``, and returns it.
"""
from __future__ import annotations

import dataclasses

import torch

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
    return loss.detach(), metrics, grads


def train_step_fn(cfg: ArchConfig, tcfg: TrainConfig, state: dict,
                  batch: dict):
    """One optimizer step on ``batch`` (tensors on the parameters'
    device).  With ``microbatches`` nm > 1 the batch is split into nm
    equal parts along its first dim; their grads are summed in float32
    and divided by nm, the loss and metrics are their means, as the
    reference's scan does."""
    params = state["params"]
    named = dict(params.named_parameters())
    names, leaves = list(named), list(named.values())
    nm = tcfg.microbatches
    if nm > 1:
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in named.items()}
        losses, metrics_all = [], []
        for i in range(nm):
            mb = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                  for k, v in batch.items()}
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
    else:
        loss, metrics, g = _value_and_grad(params, cfg, batch, leaves)
        grads = dict(zip(names, g))
    if tcfg.grad_compress:
        from repro_torch.train import compress
        gen = compress.generator_for(int(state["opt"]["step"]),
                                     leaves[0].device)
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


def build_train_step(cfg: ArchConfig, mesh, tcfg: TrainConfig | None = None,
                     abstract_state=None, abstract_batch=None):
    """Returns (fn, state_shardings, batch_shardings)."""
    tcfg = tcfg or TrainConfig()
    abstract_state = abstract_state or abstract_train_state(cfg)
    st_sh = state_shardings(abstract_state, mesh)
    b_sh = (sh.batch_shardings(abstract_batch, mesh)
            if abstract_batch is not None else None)

    def fn(state, batch):
        with use_mesh(mesh):
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
        with use_mesh(mesh):
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
        with use_mesh(mesh):
            return serve_step(params, cfg, caches, tokens, pos)

    return fn, p_sh, c_sh
