"""Fused Q/K/V projections: the counterpart of the reference's Pallas
``qkv_proj`` (the paper's Alg. 9).

``qkv_proj(x, wq, wk, wv)`` returns ``(x @ wq, x @ wk, x @ wv)`` for
``x [M, D]``, ``wq [D, Nq]`` and ``wk / wv [D, Nkv]`` with ``Nkv <= Nq``
(GQA), in one dtype (float32 or bfloat16), with float32 sums and the
outputs in x's dtype.  A CUDA tensor launches the hand-written kernel of
``csrc/qkv_proj.cu``, whose three products equal three ``tiled_matmul``
launches bit for bit (the K split, ``k_splits``, depends on M and K
alone); a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.tiled_matmul import (PLAN, split_plan,
                                              tiled_matmul_plain)

_DTYPES = (torch.float32, torch.bfloat16)


def qkv_proj_plain(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, splits: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: three f32 products, each
    rounded once to x's dtype (``splits`` as in ``tiled_matmul_plain``)."""
    return tuple(tiled_matmul_plain(x, w, splits) for w in (wq, wk, wv))


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("qkv_proj", [p, p, p, p, p, p, p, i, i, i, i, i, p,
                                     i, ctypes.POINTER(i), p])


def qkv_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [M, D] -> (q [M, Nq], k [M, Nkv], v [M, Nkv])."""
    ws = (wq, wk, wv)
    if x.dim() != 2 or any(w.dim() != 2 or w.shape[0] != x.shape[1]
                           for w in ws) or wk.shape != wv.shape \
            or wk.shape[1] > wq.shape[1]:
        raise ValueError(f"qkv_proj: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, wk {tuple(wk.shape)}, wv "
                         f"{tuple(wv.shape)}; need [M, D], [D, Nq] and two "
                         "[D, Nkv] with Nkv <= Nq")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"qkv_proj: dtypes {x.dtype}, "
                         f"{[w.dtype for w in ws]}; all must be one of "
                         f"{_DTYPES}")
    if all(t.device.type == "cpu" for t in (x, *ws)):
        return qkv_proj_plain(x, wq, wk, wv)
    runtime.require_cuda("qkv_proj", x, *ws)
    runtime.require_contiguous("qkv_proj", x=x, wq=wq, wk=wk, wv=wv)
    (M, K), nq, nkv = x.shape, wq.shape[1], wk.shape[1]
    if K == 0 or nkv == 0:
        raise ValueError("qkv_proj: the kernel takes D > 0 and Nkv > 0")
    outs = tuple(torch.empty((M, n), dtype=x.dtype, device=x.device)
                 for n in (nq, nkv, nkv))
    if M == 0:
        return outs
    splits, work = split_plan(x, (nq, nkv, nkv))
    runtime.launch("qkv_proj", _kernel(), x, x.data_ptr(),
                   *(w.data_ptr() for w in ws), *(o.data_ptr() for o in outs),
                   M, K, nq, nkv, runtime.DTYPE_CODES[x.dtype],
                   None if work is None else work.data_ptr(), splits, PLAN)
    qkv_proj.launches += 1
    return outs


qkv_proj.launches = 0
