"""Assigned input-shape cells and abstract input specs, no allocation
(port of ``repro.launch.shapes``).

Every (arch x shape) cell resolves to stand-ins for the exact tensors the
step consumes; the port's ``ShapeDtypeStruct`` is a tensor on the
``meta`` device (its shape and dtype, no storage):

  train_4k    -> train_step(state, batch)          seq 4096,   gbatch 256
  prefill_32k -> prefill_fn(params, batch)         seq 32768,  gbatch 32
  decode_32k  -> serve_step(params, caches, tok)   KV 32768,   gbatch 128
  long_500k   -> serve_step(params, caches, tok)   KV 524288,  gbatch 1

``long_500k`` is only valid for sub-quadratic archs (cfg.subquadratic);
pure full-attention archs are skipped.  Whisper's encoder context is
capped at its architectural maximum of 1500 frames for decode cells;
train/prefill apply the cell's seq_len to both encoder frames and decoder
tokens (backbone stress per the assignment).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import init_decode_state

WHISPER_MAX_ENC = 1500


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_is_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode skipped"
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, cell: ShapeCell, with_labels=True) -> dict:
    b, s = cell.global_batch, cell.seq_len
    batch = {}
    if with_labels:
        batch["labels"] = _sds((b, s), torch.int32)
    if cfg.frontend == "vision_stub":
        batch["embeds"] = _sds((b, s, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == "audio_stub":
        batch["tokens"] = _sds((b, s), torch.int32)
        enc = min(s, WHISPER_MAX_ENC) if cell.kind == "decode" else s
        batch["frames"] = _sds((b, enc, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _sds((b, s), torch.int32)
    return batch


def decode_specs(cfg: ArchConfig, cell: ShapeCell):
    """(caches, tokens, pos) abstract specs for serve_step."""
    b, s = cell.global_batch, cell.seq_len
    enc_len = min(s, WHISPER_MAX_ENC) if cfg.encoder_layers else 0
    caches = init_decode_state(cfg, b, s, enc_len=enc_len, device="meta")
    tokens = _sds((b,), torch.int32)
    pos = _sds((), torch.int32)
    return caches, tokens, pos


def input_specs(cfg: ArchConfig, cell_name: str):
    """All abstract inputs for the cell's step function."""
    cell = SHAPES[cell_name]
    if cell.kind == "train":
        return {"batch": batch_specs(cfg, cell)}
    if cell.kind == "prefill":
        return {"batch": batch_specs(cfg, cell, with_labels=False)}
    caches, tokens, pos = decode_specs(cfg, cell)
    return {"caches": caches, "tokens": tokens, "pos": pos}
