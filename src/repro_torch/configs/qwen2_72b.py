"""qwen2-72b  [arXiv:2407.10671; hf]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — GQA, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2407.10671",
)
