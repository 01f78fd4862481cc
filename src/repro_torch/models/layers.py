"""Shared neural layers of the port: norms, activations, RoPE, projections,
embedding (the reference's ``models/layers.py``, float weights only).

Every matmul routes through ``dense`` so the plain product and the
hand-written kernel are interchangeable (``models.backend``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import backend


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return F.relu(x)
    if kind in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if kind in ("swiglu", "silu"):
        return F.silu(x)
    raise ValueError(f"unknown activation {kind!r}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


def dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
          mm: str) -> torch.Tensor:
    """y = x @ w (+ bias), the product routed through backend ``mm``."""
    y = backend.matmul(x, w, mm)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def apply_dense(x: torch.Tensor, p, mm: str) -> torch.Tensor:
    """A ``Dense`` projection in x's dtype.  The reference casts the float32
    kernel to x's dtype on every call; the port stores it in the compute
    dtype once at load (the same numbers) and casts again only where x is
    in another dtype."""
    k = p.kernel if p.kernel.dtype == x.dtype else p.kernel.to(x.dtype)
    return dense(x, k, p.bias, mm)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (integer)."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)
    angles = positions[..., :, None].float() * inv_freq      # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().split(d // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Rows of the (float) table for ``tokens``, in the compute dtype."""
    rows = table.index_select(0, tokens.reshape(-1).long())
    return rows.reshape(*tokens.shape, table.shape[1]).to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T in float32 (the tied table is read in f32)."""
    return torch.matmul(x.float(), table.float().t())
