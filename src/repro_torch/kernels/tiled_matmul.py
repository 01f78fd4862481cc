"""Tiled matmul: the counterpart of the reference's Pallas ``tiled_matmul``.

``tiled_matmul(a, b)`` computes ``C[M, N] = A[M, K] @ B[K, N]`` with a
float32 accumulator and the output in A's dtype.  A CUDA tensor launches
the hand-written kernel of ``csrc/tiled_matmul.cu``; a CPU tensor runs
``tiled_matmul_plain``.  ``matmul`` folds leading dims into rows, as the
reference's ``kernels/ops.py`` does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 products and sums,
    output cast to A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("tiled_matmul", [p, p, p, i, i, i, i, p])


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N]; A and B share a dtype (float32 or
    bfloat16), are 2-D and contiguous."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not form a matmul")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"tiled_matmul: dtypes {a.dtype}, {b.dtype}; both "
                         f"must be one of {_DTYPES}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tiled_matmul_plain(a, b)
    runtime.require_cuda("tiled_matmul", a, b)
    runtime.require_contiguous("tiled_matmul", a=a, b=b)
    (M, K), N = a.shape, b.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=a.dtype, device=a.device)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    err = _kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, K, N,
                    runtime.DTYPE_CODES[a.dtype], runtime.stream_handle(a))
    runtime.check(err, "tiled_matmul")
    tiled_matmul.launches += 1
    return c


tiled_matmul.launches = 0


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., n] = x[..., k] w[k, n] through ``tiled_matmul`` (leading dims
    folded into rows)."""
    lead = x.shape[:-1]
    y = tiled_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, w.shape[1])
