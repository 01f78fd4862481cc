"""Paged decode attention: the counterpart of the reference's Pallas
``paged_decode_attention``.

One query token per sequence attends to its ``lengths[b]`` live pool
positions through its block table.  A CUDA tensor launches the
hand-written kernel of ``csrc/paged_attention.cu``; a CPU tensor runs
``paged_decode_attention_plain``.  The function is the one-lane case of
``chunked_prefill_attention`` (lane 0 at position ``lengths[b] - 1``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.chunked_prefill import (
    check_operands, chunked_prefill_attention_plain, launch)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-lane chunk walk."""
    return chunked_prefill_attention_plain(
        q[:, None], k_pool, v_pool, block_tables, lengths - 1, scale)[:, 0]


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("paged_decode_attention",
                        [p, p, p, p, p, p] + [i] * 8 + [ctypes.c_float, p])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """One-token decode attention over the pooled KV cache.

    q:            [B, h, hd]        one query token per sequence
    k/v_pool:     [NB, bs, kv, hd]  the shared block pool (row 0 = null)
    block_tables: [B, nblk] int32   physical block of each logical block
    lengths:      [B] int32         live positions per sequence (index + 1)
    -> [B, h, hd] in q's dtype

    The caller guarantees table entries lie in [0, NB).
    """
    if q.dim() != 3:
        raise ValueError("paged_decode_attention: q must be [B, h, hd]")
    check_operands("paged_decode_attention", q[:, None], k_pool, v_pool,
                   block_tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, scale)
    B, h, _ = q.shape
    out = launch("paged_decode_attention", _kernel, q, k_pool, v_pool,
                 block_tables, lengths, scale, (B, h))
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
