"""Architecture configuration schema for all assigned model families (a
copy of the reference's ``models/config.py``: pure Python, so the port
keeps its own)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "gather"   # gather (sort-FIFO) | onehot | ep
    moe_chunk: int = 1024          # dispatch token-chunk size

    # --- attention pattern ---
    window: int = 0             # sliding-window size (0 = full attention)
    local_global_ratio: int = 0  # gemma3: N local layers then 1 global
    mlp_act: str = "swiglu"     # swiglu | gelu

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma): N recurrent blocks then 1 local attn ---
    recurrent_ratio: int = 0
    lru_width: int = 0          # 0 -> d_model

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0     # >0 => enc-dec; num_layers = decoder layers

    # --- modality frontend stub ---
    frontend: str = "none"      # none | audio_stub | vision_stub

    # --- training ---
    seq_parallel: bool = False  # Megatron-SP: residual stream seq-sharded
    flash_threshold: int = 8192  # use chunked flash attention above this S
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    remat: bool = True
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.recurrent_ratio and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab rounded up to 256 so the logits'
        vocab dim shards over any mesh axis (<=256-way); padded columns are
        masked to -inf in the loss / decode (production-standard)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k) is feasible: every layer's
        state is bounded (SSM/RG-LRU) or windowed, or global layers are a
        small fraction (gemma3 local:global)."""
        return (self.family in ("ssm", "hybrid")
                or self.window > 0 or self.local_global_ratio > 0)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, h, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (h + 2 * hkv) + h * hd * d
        mlp_dense = 3 * d * f if self.mlp_act == "swiglu" else 2 * d * f
        n = v * d  # tied embedding
        per_layer = []
        for kind in layer_plan_kinds(self):
            if kind == "moe":
                e = self.num_experts
                per_layer.append(attn + d * e + e * 3 * d * f)
            elif kind == "ssm":
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                per_layer.append(d * (2 * di + 2 * self.ssm_state + nh)
                                 + di * d + 3 * di)
            elif kind == "rglru":
                w = self.lru_width
                per_layer.append(3 * d * w + 2 * w * w + mlp_dense)
            elif kind in ("attn", "attn_local", "attn_global", "enc", "dec"):
                x = attn + mlp_dense
                if kind == "dec":
                    x += d * hd * (h + 2 * hkv) + h * hd * d  # cross-attn
                per_layer.append(x)
        n += sum(per_layer)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f, e, k = self.d_model, self.d_ff, self.num_experts, self.top_k
        total = self.param_count()
        moe_all = self.num_layers * e * 3 * d * f
        moe_act = self.num_layers * k * 3 * d * f
        return total - moe_all + moe_act


def layer_plan_kinds(cfg: ArchConfig) -> list[str]:
    """Flat list of per-layer kinds, in execution order."""
    kinds = []
    if cfg.encoder_layers:
        kinds += ["enc"] * cfg.encoder_layers + ["dec"] * cfg.num_layers
        return kinds
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            kinds.append("ssm")
        elif cfg.recurrent_ratio:
            # recurrentgemma: (recurrent_ratio) RG-LRU blocks, then 1 local attn
            kinds.append("attn_local" if i % (cfg.recurrent_ratio + 1)
                         == cfg.recurrent_ratio else "rglru")
        elif cfg.local_global_ratio:
            # gemma3: N local (SWA) layers then 1 global
            kinds.append("attn_global" if i % (cfg.local_global_ratio + 1)
                         == cfg.local_global_ratio else "attn_local")
        elif cfg.is_moe:
            kinds.append("moe")
        else:
            kinds.append("attn")
    return kinds


def layer_segments(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Run-length-encoded layer plan: [(kind, count), ...].  The reference
    runs each segment as one ``lax.scan`` over its stacked params; the
    port holds it as one ``nn.ModuleList`` of ``count`` layers."""
    kinds = layer_plan_kinds(cfg)
    segs: list[tuple[str, int]] = []
    for k in kinds:
        if segs and segs[-1][0] == k:
            segs[-1] = (k, segs[-1][1] + 1)
        else:
            segs.append((k, 1))
    return segs
