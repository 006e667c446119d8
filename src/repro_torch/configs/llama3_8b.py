"""llama3-8b [dense]: 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256,
RoPE theta 500k.  [arXiv:2407.21783; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    head_dim=128, rope_theta=500000.0,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="llama3-8b-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)
