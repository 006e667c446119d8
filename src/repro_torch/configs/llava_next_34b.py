"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

AnyRes tiling vision tower is a STUB per the assignment: input_specs()
provides precomputed patch embeddings ("embeds") for the backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=20480, vocab_size=64000,
    head_dim=128, frontend="vision_stub", rope_theta=5e6,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="llava-next-34b-reduced", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    frontend="vision_stub")
