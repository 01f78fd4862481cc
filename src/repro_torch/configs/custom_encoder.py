"""custom-encoder — paper Fig. 11 / Table 1 Network #2.

Custom TNN encoder used for the portability experiment: embedding dim 200,
3 attention heads, 2 encoder layers, sequence length 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="custom-encoder",
    family="encoder",
    num_layers=2,
    d_model=200,
    num_heads=3,
    num_kv_heads=3,
    d_ff=800,
    vocab_size=8_000,
    head_dim=0,  # 200 // 3 = 66 (the paper's odd dims exercise non-128-aligned tiling)
    activation="relu",
    norm="layernorm",
    positional="learned",
    max_position_embeddings=512,
    source="paper Fig. 11 / Table 1 Network #2",
)
