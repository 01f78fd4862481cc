"""The public kernel API: the counterpart of the reference's
``kernels/ops.py``, with its names and argument order.

Each function folds leading dims into rows, as the reference does, and
calls one kernel wrapper: on CUDA tensors the hand-written kernel, on CPU
tensors its plain PyTorch version.  The reference's ``blocks`` / ``bq`` /
``bkv`` arguments and its tile-planner defaults are TPU VMEM tile choices
and are left out: each CUDA kernel picks its own tiles, and its result
does not depend on them.  ``tiled_matmul`` and ``quantized_dense`` are
the serving path's wrappers, re-exported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ffn as _ffn
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import qkv_proj as _qkv
from repro_torch.kernels.int8_matmul import quantized_dense
from repro_torch.kernels.tiled_matmul import matmul as tiled_matmul

__all__ = ["ffn1", "ffn1_gated", "flash_attention", "layernorm",
           "qkv_proj", "quantized_dense", "rmsnorm", "tiled_matmul"]


def _fold(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    return x.reshape(-1, x.shape[-1]).contiguous(), tuple(x.shape[:-1])


def qkv_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x2, lead = _fold(x)
    q, k, v = _qkv.qkv_proj(x2, wq, wk, wv)
    return (q.reshape(*lead, wq.shape[1]), k.reshape(*lead, wk.shape[1]),
            v.reshape(*lead, wv.shape[1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: [B, S, H, hd] (kv already head-repeated) -> [B, Sq, H, hd]."""
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)


def ffn1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
         activation: str = "relu") -> torch.Tensor:
    x2, lead = _fold(x)
    return _ffn.ffn1(x2, w1, b1, activation).reshape(*lead, w1.shape[1])


def ffn1_gated(x: torch.Tensor, w1: torch.Tensor, wg: torch.Tensor,
               activation: str = "swiglu") -> torch.Tensor:
    x2, lead = _fold(x)
    return _ffn.ffn1_gated(x2, w1, wg, activation).reshape(*lead,
                                                           w1.shape[1])


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    x2, lead = _fold(x)
    return _ln.layernorm(x2, gamma, beta).reshape(*lead, x.shape[-1])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    x2, lead = _fold(x)
    return _ln.rmsnorm(x2, gamma).reshape(*lead, x.shape[-1])
