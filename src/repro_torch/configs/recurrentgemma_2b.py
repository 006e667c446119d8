"""recurrentgemma-2b [hybrid]: 26L d2560 10H (GQA kv=1, MQA) d_ff=7680
vocab=256000.  Griffin pattern: 2 RG-LRU blocks : 1 local-attention block
(window 2048); lru_width=2560, head_dim=256.  [arXiv:2402.19427; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, recurrent_ratio=2, lru_width=2560, window=2048,
    rope_theta=10000.0)

REDUCED = ArchConfig(
    name="recurrentgemma-reduced", family="hybrid", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=512,
    recurrent_ratio=2, lru_width=64, window=8)
