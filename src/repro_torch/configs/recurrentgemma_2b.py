"""recurrentgemma-2b  [arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 (GeGLU) vocab=256000,
RG-LRU + local attention in a 1:2 ratio — pattern (r, r, a) repeated,
attention window 2048.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2_560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7_680,
    vocab_size=256_000,
    head_dim=256,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.19427",
    hybrid=HybridConfig(pattern=("r", "r", "a"), lru_width=2_560,
                        attention_window=2_048),
)
