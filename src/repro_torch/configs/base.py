"""Architecture configuration for the PyTorch port.

The port's own copy of ``repro.configs.base``: the same frozen
``ArchConfig`` fields, validation messages and ``reduced`` shrink rule,
restricted to what the dense, MoE (with MLA) and encoder families need
(the SSM / hybrid / frontend sub-configs are ported with their families,
ROADMAP.md Queue 1 item 12).  ``EncDecConfig`` is here for the
register-driven engine's encoder/decoder rule (``core/registers.py``
``registers_for``, ``core/spec.py`` ``maxima_for``).  Dtype defaults are
torch dtypes where the JAX package names ``jnp`` ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    experts_per_token: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    # Layers [0, first_k_dense) use a dense FFN of size ``dense_d_ff`` instead
    # of the MoE block (DeepSeek-V3 uses 3 dense layers).
    first_k_dense: int = 0
    dense_d_ff: int = 0
    router_scale: float = 1.0
    # Expert capacity factor: C = ceil(S * k / E * capacity_factor); tokens
    # routed past capacity are dropped (residual keeps them intact).
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V3) configuration."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder/decoder (Whisper) configuration."""

    num_encoder_layers: int
    # Length of the (stub) frontend output fed to the encoder.  For Whisper
    # this is n_audio_frames / 2 after the conv stack.
    encoder_seq_len: int = 1500


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture (the dense-, MoE- and encoder-family fields of
    the reference, its MLA and enc-dec sub-configs and the MTP depth)."""

    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    positional: str = "rope"  # rope | learned | none
    tie_embeddings: bool = False
    max_position_embeddings: int = 131_072
    source: str = ""
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    encdec: EncDecConfig | None = None
    # Multi-token prediction depth (DeepSeek-V3 MTP); 0 disables.  A
    # training-only head (ROADMAP.md Queue 1 item 16): serving ignores it.
    num_mtp_modules: int = 0

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> "ArchConfig":
        """Construction-time shape sanity (same checks and messages as the
        reference)."""
        if self.num_heads > 0:
            # the paper's own encoder networks use deliberately odd dims
            # (custom-encoder: 200/3) and define head_dim = floor(d/h); the
            # decode families have no such convention, so reject there
            if self.head_dim == 0 and self.mla is None \
                    and self.family != "encoder" \
                    and self.d_model % self.num_heads:
                raise ValueError(
                    f"{self.name}: d_model={self.d_model} is not divisible "
                    f"by num_heads={self.num_heads} (and no explicit "
                    "head_dim is set); pick a head count that divides "
                    "d_model or set head_dim explicitly")
            if self.num_kv_heads <= 0 or self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"{self.name}: num_kv_heads={self.num_kv_heads} must be "
                    f"a positive divisor of num_heads={self.num_heads} "
                    "(each KV head serves an equal group of query heads)")
        return self

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)


def reduced(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """A tiny same-family config for CPU tests: the reference's shrink rule
    (2 layers, d_model 64, 4 heads of 16, the GQA ratio kept; an MoE
    block shrunk to 4 experts of width 32, top-min(2, k); MLA to ranks
    32 / 16 with head dims 16 + 8 and 16; an MTP depth to 1)."""
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    small: dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        d_ff=128,
        vocab_size=128,
        max_position_embeddings=512,
        num_heads=heads,
        num_kv_heads=max(1, heads // ratio),
        head_dim=16,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            expert_d_ff=32,
            num_shared_experts=cfg.moe.num_shared_experts,
            shared_expert_d_ff=32 if cfg.moe.num_shared_experts else 0,
            first_k_dense=min(1, cfg.moe.first_k_dense),
            dense_d_ff=128 if cfg.moe.first_k_dense else 0,
        )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.num_mtp_modules:
        small["num_mtp_modules"] = 1
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


DEFAULT_PARAM_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.bfloat16
