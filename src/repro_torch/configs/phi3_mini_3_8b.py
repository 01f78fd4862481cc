"""phi3-mini-3.8b  [arXiv:2404.14219; unverified]

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064 — RoPE SwiGLU GQA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3_072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8_192,
    vocab_size=32_064,
    head_dim=96,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2404.14219",
)
