"""Synthetic token pipeline: deterministic, host-sharded, restart-safe
(the port's own copy of ``repro.data.pipeline``, pure numpy).

The generator is a pure function of (seed, step, host_slice) so that (a)
resuming from a checkpoint replays exactly the right batch, and (b) each
host in a multi-host job materializes only its slice of the global batch —
the standard input-pipeline contract at pod scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "tokens"      # tokens | embeds | frames
    d_model: int = 0          # for embeds/frames stubs
    enc_len: int = 0


def host_slice(cfg: DataConfig, process_index: int, process_count: int):
    per = cfg.global_batch // process_count
    return process_index * per, per


def make_batch(cfg: DataConfig, step: int, process_index: int = 0,
               process_count: int = 1) -> dict:
    start, per = host_slice(cfg, process_index, process_count)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start]))
    # Markov-ish synthetic tokens: next-token structure so loss can fall.
    base = rng.integers(0, cfg.vocab_size, size=(per, cfg.seq_len + 1),
                        dtype=np.int32)
    drift = np.cumsum(base % 7, axis=1).astype(np.int32) % cfg.vocab_size
    toks = (base + drift) % cfg.vocab_size
    batch = {"labels": toks[:, 1:]}
    if cfg.kind == "tokens":
        batch["tokens"] = toks[:, :-1]
    elif cfg.kind == "embeds":
        batch["embeds"] = rng.standard_normal(
            (per, cfg.seq_len, cfg.d_model)).astype(np.float32) * 0.02
    elif cfg.kind == "frames":
        batch["tokens"] = toks[:, :-1]
        batch["frames"] = rng.standard_normal(
            (per, cfg.enc_len, cfg.d_model)).astype(np.float32) * 0.02
    return batch
