"""llama3.2-3b [dense]: 28L d3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    head_dim=128, rope_theta=500000.0,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="llama3.2-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)
