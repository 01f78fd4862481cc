"""Paged decode attention: the counterpart of the reference's Pallas
``paged_decode_attention``.

One query token per sequence attends to its ``lengths[b]`` live pool
positions through its block table.  A CUDA tensor launches the
hand-written kernel of ``csrc/paged_attention.cu``; a CPU tensor runs
``paged_decode_attention_plain``.  The function is the one-lane case of
``chunked_prefill_attention`` (lane 0 at position ``lengths[b] - 1``),
and takes an int8 pool with its ``k_scale``/``v_scale`` and the fleet's
``live_kv`` (dead kv groups give exact zeros) the same way.

The kernel is that function's split-KV walk (``csrc/split_walk.cuh``) at
W = 1: a CTA's 16 query rows hold the n_rep heads of one kv group, the
grid is (B * kv * row tiles, key ranges) with the ranges planned from the
shapes and this walk's occupancy alone (``chunked_prefill.walk_plan``),
and a merge kernel combines the ranges' partials as the chunk kernel's
does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import runtime

# the head dims the kernel takes in every (q, pool) dtype pair (past them,
# as far as one CTA's shared memory holds: cp.check_head_dim)
HEAD_DIMS = tuple(range(1, cp.MAX_HEAD_DIM + 1))


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 scale: float | None = None, *,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None,
                                 live_kv: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the one-lane chunk walk."""
    return cp.chunked_prefill_attention_plain(
        q[:, None], k_pool, v_pool, block_tables, lengths - 1, scale,
        k_scale=k_scale, v_scale=v_scale, live_kv=live_kv)[:, 0]


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("paged_decode_attention",
                        [p] * 10 + [i] * 9 + [ctypes.c_float, p])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           live_kv: torch.Tensor | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """One-token decode attention over the pooled KV cache.

    q:            [B, h, hd]        one query token per sequence
    k/v_pool:     [NB, bs, kv, hd]  the shared block pool (row 0 = null)
    block_tables: [B, nblk] int32   physical block of each logical block
    lengths:      [B] int32         live positions per sequence (index + 1)
    k/v_scale:    [NB, bs, kv] f32  with an int8 pool only: per-row scales
    live_kv:      [B] int32 or None live kv groups per sequence, in [0, kv],
                                    on q's device: every head of a group
                                    g >= live_kv[b] gives exact zeros
    -> [B, h, hd] in q's dtype

    The caller guarantees table entries lie in [0, NB).  The launch never
    waits for the device: the grid comes from the shapes, and lengths,
    live_kv and the tables stay on it.  A call that splits its keys
    launches the walk and the merge kernel; ``launches`` counts calls,
    ``live_kv_launches`` those with ``live_kv``.
    """
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [B, h, hd]")
    cp.check_operands(name, q[:, None], k_pool, v_pool, block_tables,
                      lengths, k_scale, v_scale, live_kv)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lengths, scale, k_scale=k_scale,
            v_scale=v_scale, live_kv=live_kv)
    scale = cp.launch_checks(name, q, k_pool, v_pool, block_tables, lengths,
                             k_scale, v_scale, scale, live_kv)
    B, h, hd = q.shape
    cp.check_head_dim(hd, name, q.dtype, k_pool.dtype, block_tables.shape[1])
    _, bs, kv, _ = k_pool.shape
    grid, ws = cp.walk_plan(name, q[:, None], k_pool, block_tables)
    out = torch.empty_like(q)
    runtime.launch(
        name, _kernel(), q, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), cp.ptr(k_scale), cp.ptr(v_scale),
        block_tables.data_ptr(), lengths.data_ptr(), cp.ptr(live_kv),
        out.data_ptr(), cp.ptr(ws), B, h, kv, hd, bs, block_tables.shape[1],
        grid[1], runtime.DTYPE_CODES[q.dtype],
        runtime.DTYPE_CODES[k_pool.dtype], float(scale))
    paged_decode_attention.launches += 1
    paged_decode_attention.live_kv_launches += live_kv is not None
    paged_decode_attention.last_grid = grid
    return out


paged_decode_attention.launches = 0
paged_decode_attention.live_kv_launches = 0
# (CTAs of 16 query rows x column groups, key ranges) of the last launch
paged_decode_attention.last_grid = None
