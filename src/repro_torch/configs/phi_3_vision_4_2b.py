"""phi-3-vision-4.2b  [hf:microsoft/Phi-3-vision-128k-instruct; hf]

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064: the phi3-mini backbone
with a CLIP vision frontend.  The frontend is a stub: the caller supplies
precomputed patch embeddings of shape (num_tokens, d_model), which take
the first 576 positions of a prompt (zeros in serving).
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
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
    max_position_embeddings=131_072,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    frontend=FrontendConfig(kind="vision", num_tokens=576, feature_dim=3_072),
)
