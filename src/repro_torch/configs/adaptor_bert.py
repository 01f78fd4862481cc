"""adaptor-bert — the paper's primary evaluation network (§6).

BERT-base-like variant used to evaluate ADAPTOR: d_model=768, 12 heads,
12 encoder layers, default sequence length 64, GELU + LayerNorm.
Encoder-only: no decode shapes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="adaptor-bert",
    family="encoder",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3_072,
    vocab_size=30_522,
    head_dim=64,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    max_position_embeddings=512,
    source="paper §6 (BERT variant [10])",
)
