"""Architecture configuration for the PyTorch port.

The port's own copy of ``repro.configs.base``: the same frozen
``ArchConfig`` fields, validation messages and ``reduced`` shrink rule,
restricted to what the dense, vlm, MoE (with MLA), ssm, hybrid and
encoder families need.  ``SSMConfig`` is the ssm family's selective scan
(Mamba-1: state size, conv width, expansion, dt rank).  ``HybridConfig``
is the hybrid family's block pattern and widths (RG-LRU and local
attention, RecurrentGemma).  ``ShapeSpec`` and ``ALL_SHAPES`` are the
cost model's input cells (``core/analytical.py``).
``FrontendConfig`` is the vlm
family's stub vision frontend.  ``EncDecConfig`` is here for the
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
class SSMConfig:
    """Mamba-1 selective-SSM configuration."""

    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid (RG-LRU + local attention) configuration."""

    # Block pattern, repeated over depth: 'r' = RG-LRU block, 'a' = local attn.
    pattern: tuple[str, ...] = ("r", "r", "a")
    lru_width: int = 0  # 0 -> d_model
    attention_window: int = 2048


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder/decoder (Whisper) configuration."""

    num_encoder_layers: int
    # Length of the (stub) frontend output fed to the encoder.  For Whisper
    # this is n_audio_frames / 2 after the conv stack.
    encoder_seq_len: int = 1500


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: the caller provides precomputed embeddings
    (``num_tokens`` rows of width ``feature_dim`` == d_model)."""

    kind: str  # 'vision' | 'audio'
    num_tokens: int  # patch / frame token count delivered by the stub
    feature_dim: int  # embedding dim delivered by the stub (== d_model)


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture (the dense-, vlm-, MoE-, ssm-, hybrid- and
    encoder-family fields of the reference, its MLA, SSM, hybrid, enc-dec
    and frontend sub-configs and the MTP depth)."""

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
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    frontend: FrontendConfig | None = None
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

    def param_count(self) -> int:
        """Analytical parameter count (embedding + per-layer), the cost
        model's 6·N·D term (``core.analytical.arch_param_count``)."""
        from repro_torch.core.analytical import arch_param_count

        return arch_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.core.analytical import arch_param_count

        return arch_param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (seq_len x global_batch) of the cost model."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The reference's four LM shapes.  ``decode_*`` / ``long_*`` are one new
# token against a cache of seq_len, not a forward of seq_len.
TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def reduced(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """A tiny same-family config for CPU tests: the reference's shrink rule
    (2 layers, d_model 64, 4 heads of 16, the GQA ratio kept; an MoE
    block shrunk to 4 experts of width 32, top-min(2, k); MLA to ranks
    32 / 16 with head dims 16 + 8 and 16; an SSM to state 8, conv 4,
    expand 2 and dt rank 8; a hybrid pattern kept, with the
    RG-LRU at d_model (lru_width 0), a window of 32 and one pattern period
    of layers; an encoder-decoder to 2 encoder layers over 16 frames; a
    frontend to 8 tokens of 64; an MTP depth to 1).  The rule is copied as
    it is: a reduced audio config's frontend (8 frames) does not fill its
    encoder's 16 positions, so it cannot be served until a caller sets
    ``frontend.num_tokens`` to ``encoder_seq_len`` (the reference's engine
    fails there; ROADMAP.md Queue 3)."""
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
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(state_dim=8, conv_kernel=4, expand=2,
                                 dt_rank=8)
    if cfg.hybrid is not None:
        small["hybrid"] = HybridConfig(
            pattern=cfg.hybrid.pattern, lru_width=0, attention_window=32)
        small["num_layers"] = len(cfg.hybrid.pattern)  # one pattern period
    if cfg.encdec is not None:
        small["encdec"] = EncDecConfig(num_encoder_layers=2,
                                       encoder_seq_len=16)
    if cfg.frontend is not None:
        small["frontend"] = FrontendConfig(
            kind=cfg.frontend.kind, num_tokens=8, feature_dim=64)
    if cfg.num_mtp_modules:
        small["num_mtp_modules"] = 1
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


DEFAULT_PARAM_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.bfloat16
