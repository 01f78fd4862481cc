"""falcon-mamba-7b  [arXiv:2410.05355]

64L d_model=4096 (attention-free) vocab=65024, mamba-1 selective SSM,
ssm_state=16, conv 4, expand 2 (d_inner 8192), dt_rank = ceil(4096/16) = 256.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4_096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    activation="swiglu",  # mamba gate uses SiLU
    norm="rmsnorm",
    positional="none",
    source="arXiv:2410.05355",
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2, dt_rank=256),
)
