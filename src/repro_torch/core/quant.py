"""Symmetric int8 quantization (the paper's fully-quantized path, C6).

The port's copy of the reference's ``core/quant.py`` math:

* weights — per-output-channel symmetric int8 (scale = amax / 127);
* activations — per-tensor dynamic symmetric int8;
* accumulation — exact int32, rescaled to the activation dtype on the
  way out.

The numbers are the reference's bit for bit: ``scale = max(amax, 1e-8) /
127`` in float32, then ``round(x / scale)`` with a true division (not a
multiply by the reciprocal), rounding half to even as ``jnp.round`` does,
then a clip to +-127.  ``kernels.int8_matmul`` is the hand-written kernel
that consumes this format.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Leaves below this many elements stay float when serving-time weight
# quantization walks a state dict (biases, norms, tiny projections); the
# per-engine override is ``core.spec.ExecutionSpec(quant_min_size=...)``.
DEFAULT_QUANT_MIN_SIZE = 65_536


class QTensor(NamedTuple):
    values: torch.Tensor  # int8
    scale: torch.Tensor   # float32, broadcastable to values along the quant axis


def _round_clip(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize(w: torch.Tensor, axis: int | None = -1) -> QTensor:
    """Symmetric int8 quantization.  ``axis=None`` -> one per-tensor scale
    (a 0-d tensor); otherwise one scale per slice along ``axis``, reduced
    over every other axis (per-output-channel for ``[K, N]`` weights)."""
    w32 = w.float()
    if axis is None:
        scale = w32.abs().amax().clamp_min(1e-8) / 127.0
        return QTensor(_round_clip(w32, scale), scale)
    keep = axis % w32.dim()
    dims = tuple(i for i in range(w32.dim()) if i != keep)
    amax = w32.abs().amax(dim=dims, keepdim=True) if dims else w32.abs()
    scale = amax.clamp_min(1e-8) / 127.0
    return QTensor(_round_clip(w32, scale), scale)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.values.float() * q.scale


def quantize_dynamic(x: torch.Tensor) -> QTensor:
    """Per-tensor dynamic activation quantization (serving path)."""
    return quantize(x, axis=None)


def int8_matmul_ref(x: torch.Tensor, qw: QTensor) -> torch.Tensor:
    """Reference quantized matmul: dynamic-quant x, integer accumulate,
    rescale as ``(acc * sx) * sw``.  x: [..., K], qw.values: [K, N] ->
    [..., N] in x's dtype.  (The kernel's epilogue is ``acc * (sx * sw)``,
    which rounds differently; ``kernels.int8_matmul`` holds that order.)"""
    qx = quantize_dynamic(x)
    acc = torch.matmul(qx.values.double(), qw.values.double())
    out = acc.float() * qx.scale * qw.scale.reshape(1, -1)
    return out.to(x.dtype)
