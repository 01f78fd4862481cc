"""granite-moe-1b-a400m  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 32 experts top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,  # per-expert width (routed FFN); no dense FFN layers
    vocab_size=49_155,
    head_dim=64,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    moe=MoEConfig(
        num_experts=32,
        experts_per_token=8,
        expert_d_ff=512,
    ),
)
