"""Paged decode attention: the counterpart of the reference's Pallas
``paged_decode_attention``.

One query token per sequence attends to its ``lengths[b]`` live pool
positions through its block table.  A CUDA tensor launches the
hand-written kernel of ``csrc/paged_attention.cu``; a CPU tensor runs
``paged_decode_attention_plain``.  The function is the one-lane case of
``chunked_prefill_attention`` (lane 0 at position ``lengths[b] - 1``),
and takes an int8 pool with its ``k_scale``/``v_scale`` the same way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.chunked_prefill import (
    check_operands, chunked_prefill_attention_plain, launch_checks)

HEAD_DIMS = (16, 32, 64, 96, 128)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 scale: float | None = None, *,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-lane chunk walk."""
    return chunked_prefill_attention_plain(
        q[:, None], k_pool, v_pool, block_tables, lengths - 1, scale,
        k_scale=k_scale, v_scale=v_scale)[:, 0]


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("paged_decode_attention",
                        [p] * 8 + [i] * 8 + [ctypes.c_float, p])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """One-token decode attention over the pooled KV cache.

    q:            [B, h, hd]        one query token per sequence
    k/v_pool:     [NB, bs, kv, hd]  the shared block pool (row 0 = null)
    block_tables: [B, nblk] int32   physical block of each logical block
    lengths:      [B] int32         live positions per sequence (index + 1)
    k/v_scale:    [NB, bs, kv] f32  with an int8 pool only: per-row scales
    -> [B, h, hd] in q's dtype

    The caller guarantees table entries lie in [0, NB).
    """
    if q.dim() != 3:
        raise ValueError("paged_decode_attention: q must be [B, h, hd]")
    check_operands("paged_decode_attention", q[:, None], k_pool, v_pool,
                   block_tables, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lengths, scale, k_scale=k_scale,
            v_scale=v_scale)
    name = "paged_decode_attention"
    scale = launch_checks(name, q, k_pool, v_pool, block_tables, lengths,
                          k_scale, v_scale, scale)
    B, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not one of {HEAD_DIMS} "
                         "(ROADMAP.md Queue 3 fault A)")
    _, bs, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *(None if s is None else s.data_ptr() for s in (k_scale, v_scale)),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, h,
        kv, hd, bs, block_tables.shape[1], runtime.DTYPE_CODES[q.dtype],
        runtime.DTYPE_CODES[k_pool.dtype], float(scale),
        runtime.stream_handle(q))
    runtime.check(err, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
