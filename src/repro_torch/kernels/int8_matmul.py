"""Quantized matmul: the counterpart of the reference's Pallas
``int8_matmul`` and of ``quantized_dense`` in its ``kernels/ops.py``.

``int8_matmul(qx, sx, qw, sw, out_dtype)`` computes
``C[M, N] = float(sum_k qx[m, k] qw[k, n]) * (sx * sw[n])`` with an exact
integer accumulator, cast once to ``out_dtype``.  A CUDA tensor launches
the hand-written kernel of ``csrc/int8_matmul.cu``; a CPU tensor runs
``int8_matmul_plain``.  ``quantized_dense`` is the serving path: fold the
leading dims into rows, quantize the activations dynamically (one
per-tensor scale over *all* rows, dead lanes and idle slots included, as
the reference does), then the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import QTensor, quantize_dynamic
from repro_torch.kernels import runtime

OUT_DTYPES = (torch.float32, torch.bfloat16)


def int8_matmul_plain(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                      sw: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  PyTorch has no integer
    matmul on CUDA, so the sum is taken in float64: every partial sum is an
    integer below 2^53, so it is exact in any order, and its conversion to
    float32 is the kernel's one rounding of the int32 total.  The epilogue
    is the kernel's, ``acc * (sx * sw)``."""
    acc = (qx.double() @ qw.double()).float()
    return (acc * (sx.float() * sw.reshape(1, -1).float())).to(out_dtype)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("int8_matmul", [p, p, p, p, p, i, i, i, i, p])


def int8_matmul(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                sw: torch.Tensor, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] ``out_dtype``, rescaled by the
    per-tensor activation scale ``sx`` (one float32 element) and the
    per-column weight scales ``sw`` (N float32 elements)."""
    if qx.dim() != 2 or qw.dim() != 2 or qx.shape[1] != qw.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(qx.shape)} @ "
                         f"{tuple(qw.shape)} do not form a matmul")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"int8_matmul: operands are {qx.dtype}, {qw.dtype}; "
                         "both must be int8")
    (M, K), N = qx.shape, qw.shape[1]
    if sx.numel() != 1 or sw.numel() != N or sx.dtype != torch.float32 \
            or sw.dtype != torch.float32:
        raise ValueError(f"int8_matmul: scales must be float32 with 1 and "
                         f"N={N} elements, got {tuple(sx.shape)} "
                         f"{sx.dtype} and {tuple(sw.shape)} {sw.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_matmul: out_dtype {out_dtype} not one of "
                         f"{OUT_DTYPES}")
    if all(t.device.type == "cpu" for t in (qx, sx, qw, sw)):
        return int8_matmul_plain(qx, sx, qw, sw, out_dtype)
    runtime.require_cuda("int8_matmul", qx, sx, qw, sw)
    runtime.require_contiguous("int8_matmul", qx=qx, qw=qw, sx=sx, sw=sw)
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=out_dtype, device=qx.device)
    c = torch.empty((M, N), dtype=out_dtype, device=qx.device)
    err = _kernel()(qx.data_ptr(), qw.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), c.data_ptr(), M, K, N,
                    runtime.DTYPE_CODES[out_dtype], runtime.stream_handle(qx))
    runtime.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return c


int8_matmul.launches = 0


def quantized_dense(x: torch.Tensor, qw: QTensor) -> torch.Tensor:
    """Serving-path int8 dense: y[..., n] = x[..., k] w[k, n] through
    dynamic per-tensor activation quantization and ``int8_matmul``, in x's
    dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    qx = quantize_dynamic(x2)
    y = int8_matmul(qx.values.contiguous(), qx.scale, qw.values, qw.scale,
                    out_dtype=x.dtype)
    return y.reshape(*lead, qw.values.shape[1])
