"""h2o-danube-1.8b [dense]: 24L d2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention (window 4096).
[arXiv:2401.16818; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense", num_layers=24, d_model=2560,
    num_heads=32, num_kv_heads=8, d_ff=6912, vocab_size=32000,
    head_dim=80, window=4096, rope_theta=10000.0,
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="h2o-danube-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, window=8)
