"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5 local (sliding-window 1024) : 1 global pattern, 128k context.
head_dim=256.  [hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
    num_heads=8, num_kv_heads=4, d_ff=10240, vocab_size=262144,
    head_dim=256, local_global_ratio=5, window=1024, rope_theta=1e6,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="gemma3-reduced", family="dense", num_layers=6, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    local_global_ratio=5, window=8)
