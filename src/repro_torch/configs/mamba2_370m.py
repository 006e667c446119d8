"""mamba2-370m [ssm]: 48L d1024, attention-free, ssm_state=128 (SSD).
expand=2 -> d_inner=2048, head_dim=64 -> 32 SSD heads.
[arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64)

REDUCED = ArchConfig(
    name="mamba2-reduced", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16)
