"""Matmul routing: the plain PyTorch product or the hand-written kernel.

The counterpart of the reference's ``models/backend.py``.  The reference
selects its backend with a thread-local context manager read at trace
time; the port runs eagerly, so the model passes the backend name down
explicitly.

* ``"xla"``    — PyTorch's own product.  On a CUDA device: bf16 (or f32)
  operands with a float32 accumulator and the output in x's dtype.  On the
  CPU the operands are upcast to float32 first, as the reference's CPU
  path does.
* ``"pallas"`` — the hand-written ``tiled_matmul`` kernel (its plain
  version on CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import tiled_matmul

MATMUL_BACKENDS = ("xla", "pallas")


def matmul(x: torch.Tensor, w: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] w[k, n]; float32 accumulate, output in
    x's dtype (``w`` is already in x's dtype)."""
    if impl == "pallas":
        return tiled_matmul.matmul(x, w)
    if impl != "xla":
        raise ValueError(f"unknown backend {impl!r}; one of {MATMUL_BACKENDS}")
    if x.device.type == "cpu":
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w)
