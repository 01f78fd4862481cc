"""Architecture configuration for the PyTorch port.

The port's own copy of ``repro.configs.base``: the same frozen
``ArchConfig`` fields, validation messages and ``reduced`` shrink rule,
restricted to what the dense decoder family needs (the MoE / MLA / SSM /
hybrid / enc-dec sub-configs are ported with their families, ROADMAP.md
Queue 1 items 11-12).  Dtype defaults are torch dtypes where the JAX
package names ``jnp`` ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture (the dense-family fields of the reference)."""

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

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> "ArchConfig":
        """Construction-time shape sanity (same checks and messages as the
        reference, minus the encoder-family exemption)."""
        if self.num_heads > 0:
            if self.head_dim == 0 and self.d_model % self.num_heads:
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
    (2 layers, d_model 64, 4 heads of 16, the GQA ratio kept)."""
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
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


DEFAULT_PARAM_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.bfloat16
