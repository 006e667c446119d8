"""Segment-structured transformer: init / train forward / decode step
(port of ``repro.models.transformer``).

The layer stack is run-length-encoded into segments of identical layer
kind (``config.layer_segments``).  The reference stacks each segment's
parameters and runs it as one ``lax.scan``; the port holds each segment
as an ``nn.ModuleList`` of layers (``LM.segments``, in
``layer_segments`` order) and runs them in turn.  The functions keep the
reference's names and arguments, ``params`` being the :class:`LM`
module; a layer's ``forward`` is the reference's ``_apply_layer_train``
for its kind, ``decode`` its ``_apply_layer_decode``.  Decode caches are
the reference's: one dict a segment, each leaf stacked over the
segment's layers.  ``remat`` and ``seq_parallel`` change no value on one
rank, and the port ignores them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig, layer_segments
from repro_torch.models.layers import (MLP, cross_entropy_loss, layer_norm,
                                       normal_, rms_norm, sinusoidal)

LOCAL_WINDOW_DEFAULT = 1024
ATTN_KINDS = ("attn", "attn_local", "attn_global", "moe", "enc", "dec")


def _window_for(cfg: ArchConfig, kind: str) -> int:
    if kind == "attn_local":
        return cfg.window or LOCAL_WINDOW_DEFAULT
    if kind == "attn" and cfg.window:
        return cfg.window
    return 0


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Layers, one module a kind family
# ---------------------------------------------------------------------------

class AttentionLayer(nn.Module):
    """An attention layer of kind ``attn``, ``attn_local``, ``attn_global``,
    ``moe`` (its MLP a mixture of experts), ``enc`` or ``dec`` (whisper:
    LayerNorm with biases, no RoPE; ``dec`` adds cross-attention)."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.kind = kind
        self.ln1 = _norm(d, device)
        self.attn = attn.Attention(d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, dtype, device)
        self.ln2 = _norm(d, device)
        if kind == "moe":
            self.moe = moe_mod.MoE(d, f, cfg.num_experts, dtype, device)
        else:
            self.mlp = MLP(d, f, cfg.mlp_act, dtype, device)
        if kind == "dec":
            self.ln_x = _norm(d, device)
            self.xattn = attn.Attention(d, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.head_dim, dtype, device)
        if kind in ("enc", "dec"):   # whisper uses LayerNorm biases
            self.ln1_b = _norm(d, device)
            self.ln2_b = _norm(d, device)
            if kind == "dec":
                self.ln_x_b = _norm(d, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        (self.moe if self.kind == "moe" else self.mlp).reset_parameters(
            generator)
        if self.kind == "dec":
            self.xattn.reset_parameters(generator)

    def _norm1(self, x, eps):
        if self.kind in ("enc", "dec"):
            return layer_norm(x, 1.0 + self.ln1, self.ln1_b, eps)
        return rms_norm(x, self.ln1, eps)

    def _norm2(self, x, eps):
        if self.kind in ("enc", "dec"):
            return layer_norm(x, 1.0 + self.ln2, self.ln2_b, eps)
        return rms_norm(x, self.ln2, eps)

    def _ffn(self, h2, cfg: ArchConfig):
        if self.kind == "moe":
            return moe_mod.moe_forward(h2, self.moe, top_k=cfg.top_k,
                                       capacity_factor=cfg.capacity_factor,
                                       dispatch=cfg.moe_dispatch,
                                       chunk=cfg.moe_chunk)
        return self.mlp(h2), None

    def forward(self, x, positions, cfg: ArchConfig, enc_out=None):
        eps = cfg.norm_eps
        h = self._norm1(x, eps)
        theta = 0.0 if self.kind in ("enc", "dec") else cfg.rope_theta
        x = x + attn.attention_block(
            h, self.attn, positions=positions, causal=self.kind != "enc",
            window=_window_for(cfg, self.kind), rope_theta=theta,
            flash_threshold=cfg.flash_threshold)
        if self.kind == "dec":
            hx = layer_norm(x, 1.0 + self.ln_x, self.ln_x_b, eps)
            k = torch.einsum("bsd,dhk->bshk", enc_out, self.xattn.wk)
            v = torch.einsum("bsd,dhk->bshk", enc_out, self.xattn.wv)
            x = x + attn.attention_block(
                hx, self.xattn, positions=positions, causal=False,
                rope_theta=0.0, kv_override=(k, v))
        y, aux = self._ffn(self._norm2(x, eps), cfg)
        return x + y, aux

    def decode(self, x, cache: dict, pos: int, cfg: ArchConfig):
        eps = cfg.norm_eps
        h = self._norm1(x, eps)
        theta = 0.0 if self.kind == "dec" else cfg.rope_theta
        y, kv = attn.attention_decode(h, self.attn,
                                      {"k": cache["k"], "v": cache["v"]},
                                      pos, window=_window_for(cfg, self.kind),
                                      rope_theta=theta)
        x = x + y
        new_cache = dict(cache)
        new_cache.update(kv)
        if self.kind == "dec":
            # the cross-attention cache (xk, xv) is read, never filled
            hx = layer_norm(x, 1.0 + self.ln_x, self.ln_x_b, eps)
            x = x + attn.attention_block(
                hx, self.xattn,
                positions=torch.full((x.shape[0], 1), pos, device=x.device),
                causal=False, rope_theta=0.0,
                kv_override=(cache["xk"], cache["xv"]))
        y, _ = self._ffn(self._norm2(x, eps), cfg)
        return x + y, new_cache


class SSMLayer(nn.Module):
    """A Mamba-2 SSD layer (kind ``ssm``)."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.ssm = ssm_mod.SSM(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                               cfg.ssm_state, cfg.ssm_conv_width, dtype,
                               device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ssm.reset_parameters(generator)

    def forward(self, x, positions, cfg: ArchConfig, enc_out=None):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        return x + ssm_mod.ssm_forward(h, self.ssm, expand=cfg.ssm_expand,
                                       head_dim=cfg.ssm_head_dim,
                                       state=cfg.ssm_state), None

    def decode(self, x, cache: dict, pos: int, cfg: ArchConfig):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        y, new_cache = ssm_mod.ssm_decode(h, self.ssm, cache,
                                          expand=cfg.ssm_expand,
                                          head_dim=cfg.ssm_head_dim,
                                          state=cfg.ssm_state)
        return x + y, new_cache


class RGLRULayer(nn.Module):
    """A Griffin recurrent layer (kind ``rglru``): RG-LRU block, then MLP."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _norm(d, device)
        self.rglru = rglru_mod.RGLRU(d, cfg.lru_width, 4, dtype, device)
        self.ln2 = _norm(d, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_act, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.rglru.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, positions, cfg: ArchConfig, enc_out=None):
        eps = cfg.norm_eps
        x = x + rglru_mod.rglru_forward(rms_norm(x, self.ln1, eps),
                                        self.rglru)
        return x + self.mlp(rms_norm(x, self.ln2, eps)), None

    def decode(self, x, cache: dict, pos: int, cfg: ArchConfig):
        eps = cfg.norm_eps
        y, new_cache = rglru_mod.rglru_decode(rms_norm(x, self.ln1, eps),
                                              self.rglru, cache)
        x = x + y
        return x + self.mlp(rms_norm(x, self.ln2, eps)), new_cache


LAYERS = {**{k: AttentionLayer for k in ATTN_KINDS}, "ssm": SSMLayer,
          "rglru": RGLRULayer}


class LM(nn.Module):
    """The reference's parameter tree as modules: ``embed``
    [vocab_padded, d] (tied), ``final_ln``, ``enc_final_ln`` (enc-dec
    only) and ``segments``, one ``nn.ModuleList`` of layers a segment."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_padded, cfg.d_model), dtype=dtype, device=device))
        self.final_ln = _norm(cfg.d_model, device)
        if cfg.encoder_layers:
            self.enc_final_ln = _norm(cfg.d_model, device)
        self.segments = nn.ModuleList(
            nn.ModuleList(LAYERS[kind](kind, cfg, dtype, device)
                          for _ in range(count))
            for kind, count in layer_segments(cfg))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every weight drawn from ``generator`` (on the parameters'
        device), layer by layer, then ``embed``; the norms stay zero."""
        for seg in self.segments:
            for layer in seg:
                layer.reset_parameters(generator)
        normal_(self.embed, generator, 0.02)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> LM:
    """Random weights from ``generator``, on the generator's device."""
    params = LM(cfg, dtype, device=generator.device)
    params.reset_parameters(generator)
    return params


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> LM:
    """The parameter tree's shapes and dtypes, allocating nothing (the
    ``meta`` device)."""
    return LM(cfg, dtype, device="meta")


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------

def apply_segment_train(kind: str, layers: nn.ModuleList, x, positions,
                        cfg: ArchConfig, enc_out=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        x, a = layer(x, positions, cfg, enc_out)
        if a is not None:
            aux = aux + a
    return x, aux


def forward_train(params: LM, cfg: ArchConfig, tokens=None, embeds=None,
                  frames=None):
    """Returns (logits [B, S, vocab_padded], aux_loss)."""
    segs = layer_segments(cfg)
    if embeds is not None:
        x = embeds                       # vlm stub: precomputed embeddings
    else:
        x = params.embed[tokens.long()]
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    enc_out = None
    idx = 0
    if cfg.encoder_layers:
        # whisper: encoder over frame embeddings with sinusoidal positions
        xe = frames + sinusoidal(frames.shape[1], d, frames)
        for (kind, count) in segs:
            if kind != "enc":
                break
            xe, _ = apply_segment_train(
                kind, params.segments[idx], xe,
                torch.arange(frames.shape[1], device=x.device), cfg)
            idx += 1
        enc_out = rms_norm(xe, params.enc_final_ln, cfg.norm_eps)
        x = x + sinusoidal(s, d, x)
    for (kind, count) in segs[idx:]:
        x, aux = apply_segment_train(kind, params.segments[idx], x,
                                     positions, cfg, enc_out)
        aux_total = aux_total + aux
        idx += 1
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, params.embed)
    return logits, aux_total


def prefill_step(params: LM, cfg: ArchConfig, batch: dict):
    """Inference prefill: full forward over the prompt; logits [B, V] of
    the last position (vocab-padded, as ``forward_train``'s)."""
    logits, _ = forward_train(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        frames=batch.get("frames"))
    return logits[:, -1]


def loss_fn(params: LM, cfg: ArchConfig, batch: dict):
    logits, aux = forward_train(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        frames=batch.get("frames"))
    loss = cross_entropy_loss(logits, batch["labels"],
                              batch.get("loss_mask"),
                              valid_vocab=cfg.vocab_size)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, enc_len: int = 0,
                      device=None) -> list:
    """Per-segment cache stacks on ``device`` (None = the CUDA card).
    cache_len = full KV length for global layers; windowed layers get a
    ring of min(window, cache_len)."""
    dev = resolve_device(device)
    caches = []
    for kind, count in layer_segments(cfg):
        if kind in ("attn", "attn_local", "attn_global", "moe", "dec"):
            w = _window_for(cfg, kind)
            clen = min(w, cache_len) if w else cache_len
            lens = {"k": clen, "v": clen}
            if kind == "dec":
                lens.update(xk=enc_len, xv=enc_len)
            caches.append({
                name: torch.zeros((count, batch, n, cfg.num_kv_heads,
                                   cfg.head_dim), dtype=dtype, device=dev)
                for name, n in lens.items()})
        elif kind in ("ssm", "rglru"):
            c1 = (ssm_mod.ssm_init_cache(
                batch, cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                cfg.ssm_state, cfg.ssm_conv_width, dtype, dev)
                if kind == "ssm" else
                rglru_mod.rglru_init_cache(batch, cfg.lru_width, 4, dtype,
                                           dev))
            caches.append({k: v.expand(count, *v.shape).clone()
                           for k, v in c1.items()})
        elif kind == "enc":
            caches.append({})
    return caches


def serve_step(params: LM, cfg: ArchConfig, caches: list, tokens, pos: int):
    """One decode step.  tokens: int[B]; pos: the position (an int).

    Returns (logits [B, vocab_size], new caches); ``caches`` is not
    modified."""
    x = params.embed[tokens.long()][:, None]          # [B, 1, d]
    if cfg.encoder_layers:
        x = x + sinusoidal(1, cfg.d_model, x)
    new_caches = []
    for seg_i, (kind, count) in enumerate(layer_segments(cfg)):
        cache = caches[seg_i]
        if kind == "enc":
            new_caches.append(cache)
            continue
        outs = []
        for j, layer in enumerate(params.segments[seg_i]):
            x, c = layer.decode(x, {k: v[j] for k, v in cache.items()}, pos,
                                cfg)
            outs.append(c)
        new_caches.append({k: torch.stack([c[k] for c in outs])
                           for k in outs[0]})
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x[:, 0:1], params.embed)[:, 0]
    return logits[:, : cfg.vocab_size], new_caches
