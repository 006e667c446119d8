"""Gradient compression: int8 quantization with per-tensor scale (port of
``repro.train.compress``).

Quantize to int8 with stochastic rounding, dequantize after.  The noise
comes from an explicit ``torch.Generator`` (the reference's comes from a
JAX key, whose stream torch cannot reproduce), so the port is held to the
contract rather than to the reference's bits: int8 range, an error of at
most one scale an element, a mean error near zero, the same output for
the same seed.

A sharded gradient (a ``DTensor``) quantizes to what the whole tensor
would: its scale is the whole tensor's max |g| (a reduction over the
ranks), and every rank draws the noise at the whole shape from its copy
of the same generator, in the same leaf order, and keeps its own block.
So ``q``, the scales and everything after them equal one rank's, bit for
bit; ``q`` keeps the gradient's placements and the scale is replicated.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


def generator_for(step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(0, step)``: the
    counterpart of ``jax.random.fold_in(jax.random.key(0), step)``."""
    value = int(np.random.SeedSequence([0, step]).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device).manual_seed(value)


def quantize(g: torch.Tensor, generator: torch.Generator
             ) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(g, DTensor):
        return _quantize_sharded(g, generator)
    scale = torch.max(torch.abs(g.float())) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    x = g.float() / scale
    noise = torch.rand(g.shape, generator=generator, device=g.device,
                       dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def _quantize_sharded(g: DTensor, generator: torch.Generator
                      ) -> tuple[DTensor, DTensor]:
    mesh, placements = g.device_mesh, g.placements
    local = g.to_local().float()
    scale = torch.abs(g.float()).max().full_tensor() / 127.0
    scale = torch.clamp(scale, min=1e-12)
    noise = torch.rand(g.shape, generator=generator, device=local.device,
                       dtype=torch.float32) - 0.5
    noise = distribute_tensor(noise, mesh, placements,
                              src_data_rank=None).to_local()
    q = torch.clamp(torch.round(local / scale + noise), -127, 127).to(
        torch.int8)
    q = DTensor.from_local(q, mesh, placements, run_check=False,
                           shape=g.shape, stride=g.stride())
    return q, DTensor.from_local(scale, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, generator: torch.Generator):
    """(quantized, scales), each keyed like ``grads``; the leaves draw
    their noise from ``generator`` in ``grads``' order."""
    out = {k: quantize(g, generator) for k, g in grads.items()}
    return {k: q for k, (q, _) in out.items()}, \
        {k: s for k, (_, s) in out.items()}


def decompress_tree(qtree: dict, stree: dict) -> dict:
    return {k: dequantize(q, stree[k]) for k, q in qtree.items()}
