"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) d_ff=768 (per expert),
vocab=151936, MoE 128 experts top-8.  head_dim=128 (decoupled from d_model
per the Qwen3 config).  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, d_ff=768, vocab_size=151936,
    head_dim=128, num_experts=128, top_k=8, rope_theta=1e6,
    # optimized defaults from the §Perf hillclimb (EXPERIMENTS.md):
    # shard_map expert-parallel FIFO dispatch, 2k-token chunks
    moe_dispatch="ep", moe_chunk=2048,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="qwen3-moe-reduced", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=512, head_dim=32,
    num_experts=8, top_k=4)
