"""shallow-transformer — paper Table 1 Network #1.

The 'shallow transformer' baseline used by Fang et al. [44] / Qi et al.
[19, 33]: 2 encoder layers, d_model=512, 8 heads, d_ff=2048, SL 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="shallow-transformer",
    family="encoder",
    num_layers=2,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2_048,
    vocab_size=30_522,
    head_dim=64,
    activation="relu",
    norm="layernorm",
    positional="learned",
    max_position_embeddings=512,
    source="paper Table 1 Network #1",
)
