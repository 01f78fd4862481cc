"""Shared neural layers of the port: norms, activations, RoPE, projections,
embedding (the reference's ``models/layers.py``).

Every matmul routes through ``dense`` (``models.backend``) and every norm
through ``apply_norm``, so the plain functions and the hand-written
kernels are interchangeable.  A weight may be an int8 ``QTensor`` (the
paper's fully-quantized serving path): under ``"pallas"`` it goes through
the hand-written ``int8_matmul``, otherwise it is dequantized to x's
dtype for the plain product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QTensor
from repro_torch.kernels import layernorm as ln_kernels
from repro_torch.kernels.int8_matmul import quantized_dense
# the norms' plain arithmetic is the kernels' plain versions
from repro_torch.kernels.layernorm import layernorm_plain as layernorm
from repro_torch.kernels.layernorm import rmsnorm_plain as rmsnorm
from repro_torch.models import backend


def apply_norm(x: torch.Tensor, p, kind: str, mm: str) -> torch.Tensor:
    """The block's norm over x's last axis, routed through backend ``mm``:
    under ``"pallas"`` the hand-written kernel over ``[rows, D]`` (its
    plain version on CPU tensors), otherwise the plain function."""
    if mm == "pallas":
        x2 = x.reshape(-1, x.shape[-1])
        y = ln_kernels.rmsnorm(x2, p.scale) if kind == "rmsnorm" \
            else ln_kernels.layernorm(x2, p.scale, p.bias)
        return y.view(x.shape)
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


def dense(x: torch.Tensor, w: torch.Tensor | QTensor,
          bias: torch.Tensor | None, mm: str) -> torch.Tensor:
    """y = x @ w (+ bias), the product routed through backend ``mm``.  An
    int8 ``w`` takes dynamic activation quantization and ``int8_matmul``
    under ``"pallas"``; otherwise it is dequantized in x's dtype."""
    if isinstance(w, QTensor):
        if mm == "pallas":
            y = quantized_dense(x, w)
            return y if bias is None else y + bias.to(y.dtype)
        w = w.values.to(x.dtype) * w.scale.to(x.dtype)
    y = backend.matmul(x, w, mm)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def apply_dense(x: torch.Tensor, p, mm: str,
                bias: bool = True) -> torch.Tensor:
    """A ``Dense`` projection in x's dtype.  The reference casts the float32
    kernel to x's dtype on every call; the port stores it in the compute
    dtype once at load (the same numbers) and casts again only where x is
    in another dtype.  An int8 kernel is passed on with its scales.
    ``bias=False`` leaves the bias out (a row-parallel rank's partial
    product, whose sum takes the bias once)."""
    k = p.kernel
    if k.dtype == torch.int8:
        k = QTensor(k, p.kernel_scale)
    elif k.dtype != x.dtype:
        k = k.to(x.dtype)
    return dense(x, k, p.bias if bias else None, mm)


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


def embed(tokens: torch.Tensor, table: torch.Tensor | QTensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table for ``tokens``, in the compute dtype.  A per-row
    int8 table gathers rows and row scales and multiplies them in the
    compute dtype."""
    idx = tokens.reshape(-1).long()
    if isinstance(table, QTensor):
        rows = table.values.index_select(0, idx).to(dtype) \
            * table.scale.index_select(0, idx).to(dtype)
        d = table.values.shape[1]
    else:
        rows, d = table.index_select(0, idx).to(dtype), table.shape[1]
    return rows.reshape(*tokens.shape, d)


def unembed(x: torch.Tensor, table: torch.Tensor | QTensor) -> torch.Tensor:
    """Logits = x @ table^T in float32 (the tied table is read in f32, an
    int8 one dequantized to f32 first)."""
    if isinstance(table, QTensor):
        table = table.values.float() * table.scale.float()
    return torch.matmul(x.float(), table.float().t())
