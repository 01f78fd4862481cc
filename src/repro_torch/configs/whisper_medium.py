"""whisper-medium  [arXiv:2212.04356]

Enc-dec, 24 encoder + 24 decoder layers, d_model=1024 16H (kv=16) d_ff=4096
vocab=51865, GELU FFNs with biases, LayerNorm, learned positions (the
decoder's table of 4096 rows, the encoder's of its 1500 frames).  The conv
audio frontend is a stub: the caller supplies precomputed frame embeddings
(1500 x d_model after the conv downsampling); in serving they are zeros.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig, FrontendConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4_096,
    vocab_size=51_865,
    head_dim=64,
    activation="gelu",
    norm="layernorm",
    positional="learned",
    max_position_embeddings=4_096,
    source="arXiv:2212.04356",
    encdec=EncDecConfig(num_encoder_layers=24, encoder_seq_len=1_500),
    frontend=FrontendConfig(kind="audio", num_tokens=1_500, feature_dim=1_024),
)
