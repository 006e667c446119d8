"""whisper-small [audio]: 12 encoder + 12 decoder layers, d768 12H d_ff=3072
vocab=51865.  Conv frontend STUBBED: input_specs() provides precomputed
frame embeddings.  Sinusoidal positions, LayerNorm, GELU MLP.
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_layers=12, mlp_act="gelu", rope_theta=0.0,
    frontend="audio_stub",
    # §Perf: Megatron-style sequence parallelism (EXPERIMENTS.md)
    seq_parallel=True)

REDUCED = ArchConfig(
    name="whisper-small-reduced", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    encoder_layers=2, mlp_act="gelu", rope_theta=0.0,
    frontend="audio_stub")
