"""deepseek-v3-671b  [arXiv:2412.19437; hf]

61L d_model=7168 128H d_ff=2048(routed) vocab=129280, MoE 256e top-8,
MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128),
1 shared + 256 routed experts, first 3 layers dense (d_ff 18432), MTP depth 1.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7_168,
    num_heads=128,
    num_kv_heads=128,  # MLA: all heads read the shared compressed latent
    d_ff=2_048,  # routed expert width
    vocab_size=129_280,
    head_dim=128,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2412.19437",
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        expert_d_ff=2_048,
        num_shared_experts=1,
        shared_expert_d_ff=2_048,
        first_k_dense=3,
        dense_d_ff=18_432,
        router_scale=2.5,
    ),
    mla=MLAConfig(
        q_lora_rank=1_536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    num_mtp_modules=1,
)
