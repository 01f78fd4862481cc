"""codeqwen1.5-7b  [hf:Qwen/CodeQwen1.5-7B; hf]

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416 — qwen1.5 arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13_440,
    vocab_size=92_416,
    head_dim=128,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/CodeQwen1.5-7B",
)
