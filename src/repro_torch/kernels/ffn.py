"""The first FFN projection with its epilogue fused: the counterpart of the
reference's Pallas ``ffn1`` and ``ffn1_gated``.

``ffn1(x, w1, b1, activation)`` computes ``act(x @ w1 + b1)`` and
``ffn1_gated(x, w1, wg, activation)`` computes ``act(x @ wg) * (x @ w1)``,
for ``x [M, D]`` and weights ``[D, F]`` in one dtype (float32 or
bfloat16), with float32 sums and one rounding to x's dtype.  ``b1`` is
``[F]`` in float32 or x's dtype.  Activations, by the reference's names:
``relu``, ``gelu`` / ``geglu`` (the tanh form), ``silu`` / ``swiglu``
(``x * sigmoid(x)``).  A CUDA tensor launches the hand-written kernel of
``csrc/ffn.cu``; a CPU tensor runs the plain version.  In bf16 the
kernel splits K as ``tiled_matmul`` does (``k_splits``) and applies the
epilogue to the ordered sum of the ranges' partial sums.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.tiled_matmul import (
    PLAN, matmul_partials_plain, reduce_partials_plain, split_plan)

_DTYPES = (torch.float32, torch.bfloat16)
# activation name -> the C interface's code (0 relu, 1 tanh-gelu, 2 silu)
ACTIVATIONS = {"relu": 0, "gelu": 1, "geglu": 1, "silu": 2, "swiglu": 2}


def _act_code(activation: str) -> int:
    if activation not in ACTIVATIONS:
        raise ValueError(activation)
    return ACTIVATIONS[activation]


def act(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's ``_act`` on a float32 tensor."""
    code = _act_code(activation)
    if code == 0:
        return torch.relu(y)
    if code == 1:
        return F.gelu(y, approximate="tanh")
    return F.silu(y)


def _sum(x: torch.Tensor, w: torch.Tensor, splits: int) -> torch.Tensor:
    return reduce_partials_plain(matmul_partials_plain(x, w, splits))


def ffn1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               activation: str = "relu", splits: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``splits``: the K ranges'
    partial sums added in order before the epilogue, as the kernel's
    split)."""
    y = _sum(x, w1, splits) + b1.float()
    return act(y, activation).to(x.dtype)


def ffn1_gated_plain(x: torch.Tensor, w1: torch.Tensor, wg: torch.Tensor,
                     activation: str = "swiglu",
                     splits: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``splits`` as in
    ``ffn1_plain``)."""
    h = _sum(x, w1, splits)
    g = _sum(x, wg, splits)
    return (act(g, activation) * h).to(x.dtype)


def _check(name: str, x: torch.Tensor, *ws: torch.Tensor) -> None:
    if x.dim() != 2 or any(w.dim() != 2 or w.shape[0] != x.shape[1]
                           or w.shape != ws[0].shape for w in ws):
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ "
                         f"{[tuple(w.shape) for w in ws]} do not form a "
                         "matmul")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"{name}: dtypes {x.dtype}, "
                         f"{[w.dtype for w in ws]}; all must be one of "
                         f"{_DTYPES}")


@functools.cache
def _kernels():
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = ctypes.POINTER(i)
    return (runtime.bind("ffn1",
                         [p, p, p, p, i, i, i, i, i, i, p, i, plan, p]),
            runtime.bind("ffn1_gated",
                         [p, p, p, p, i, i, i, i, i, p, i, plan, p]))


def ffn1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
         activation: str = "relu") -> torch.Tensor:
    """act(x @ w1 + b1): [M, D] @ [D, F] -> [M, F] in x's dtype."""
    code = _act_code(activation)
    _check("ffn1", x, w1)
    if b1.shape != (w1.shape[1],) or b1.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"ffn1: bias must be [F={w1.shape[1]}] in float32 "
                         f"or {x.dtype}, got {tuple(b1.shape)} {b1.dtype}")
    if all(t.device.type == "cpu" for t in (x, w1, b1)):
        return ffn1_plain(x, w1, b1, activation)
    runtime.require_cuda("ffn1", x, w1, b1)
    runtime.require_contiguous("ffn1", x=x, w1=w1, b1=b1)
    (M, K), N = x.shape, w1.shape[1]
    if K == 0:
        raise ValueError("ffn1: the kernel takes D > 0")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    splits, ws = split_plan(x, (N,))
    err = _kernels()[0](x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        out.data_ptr(), M, K, N, runtime.DTYPE_CODES[x.dtype],
                        int(b1.dtype == torch.float32), code,
                        None if ws is None else ws.data_ptr(), splits, PLAN,
                        runtime.stream_handle(x))
    runtime.check(err, "ffn1")
    ffn1.launches += 1
    return out


def ffn1_gated(x: torch.Tensor, w1: torch.Tensor, wg: torch.Tensor,
               activation: str = "swiglu") -> torch.Tensor:
    """act(x @ wg) * (x @ w1): [M, D] @ 2 x [D, F] -> [M, F] in x's
    dtype."""
    code = _act_code(activation)
    _check("ffn1_gated", x, w1, wg)
    if all(t.device.type == "cpu" for t in (x, w1, wg)):
        return ffn1_gated_plain(x, w1, wg, activation)
    runtime.require_cuda("ffn1_gated", x, w1, wg)
    runtime.require_contiguous("ffn1_gated", x=x, w1=w1, wg=wg)
    (M, K), N = x.shape, w1.shape[1]
    if K == 0:
        raise ValueError("ffn1_gated: the kernel takes D > 0")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    splits, ws = split_plan(x, (N, N))
    err = _kernels()[1](x.data_ptr(), w1.data_ptr(), wg.data_ptr(),
                        out.data_ptr(), M, K, N, runtime.DTYPE_CODES[x.dtype],
                        code, None if ws is None else ws.data_ptr(), splits,
                        PLAN, runtime.stream_handle(x))
    runtime.check(err, "ffn1_gated")
    ffn1_gated.launches += 1
    return out


ffn1.launches = 0
ffn1_gated.launches = 0
