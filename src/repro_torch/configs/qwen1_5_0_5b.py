"""qwen1.5-0.5b  [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936 — QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2_816,
    vocab_size=151_936,
    head_dim=64,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
