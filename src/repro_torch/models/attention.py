"""GQA attention of the port: full-sequence, paged decode and the paged
mixed (chunk) step.

The counterpart of the reference's ``models/attention.py`` GQA half with
the float KV codec.  The dtype flow is the reference's: scores are an
einsum in the promoted operand dtype, softmax in float32, and the
probabilities are cast to V's dtype before the PV product.

The paged pool is updated **in place** (``index_put_``): the reference
donates the cache to its jitted step, the port writes the new K/V rows
straight into the pool tensors.  Writes past a slot's blocks and writes
of dead lanes are routed to the null block explicitly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import masking
from repro_torch.core.paging import NULL_BLOCK
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.layers import apply_dense, apply_rope

NEG_INF = -0.7 * torch.finfo(torch.float32).max


class KVCache(NamedTuple):
    """The paged pool: ``[layers, pool_blocks, block_size, kv, hd]`` K and V
    (pool row 0 is the null block)."""

    k: torch.Tensor
    v: torch.Tensor


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, kv, hd] -> [B, S, kv*n_rep, hd] (GQA head grouping)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
        .reshape(b, s, kv * n_rep, hd)


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   kv_len_mask: torch.Tensor | None = None,
                   scale: float | None = None) -> torch.Tensor:
    """q: [B,Sq,h,hd], k/v: [B,Skv,h,hd] (kv already repeated to h).

    ``kv_len_mask``: [B, Skv] live positions, or [B, Sq, Skv] per lane.
    Output in the dtype of (p cast to v's dtype) x v.
    """
    _, sq, _, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qs, ks = _promote(q, k)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, ks).float() * scale
    if causal:
        kv_pos = torch.arange(k.shape[1], device=q.device)
        mask = kv_pos[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
    if kv_len_mask is not None:
        m = kv_len_mask[:, None, None, :] if kv_len_mask.dim() == 2 \
            else kv_len_mask[:, None, :, :]
        s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def gqa_qkv(x: torch.Tensor, p, cfg: ArchConfig, positions: torch.Tensor,
            mm: str):
    b_, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = apply_dense(x, p.wq, mm).reshape(b_, s, h, hd)
    k = apply_dense(x, p.wk, mm).reshape(b_, s, kv, hd)
    v = apply_dense(x, p.wv, mm).reshape(b_, s, kv, hd)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(x: torch.Tensor, p, cfg: ArchConfig, positions, mm: str
                  ) -> torch.Tensor:
    """Full-sequence causal GQA attention (the forward pass)."""
    b_, s, _ = x.shape
    q, k, v = gqa_qkv(x, p, cfg, positions, mm)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    o = full_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                       causal=True)
    return apply_dense(o.reshape(b_, s, -1), p.wo, mm)


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                live: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Masked attention over a sequence-major [B, S, kv, hd] view."""
    b_, nq = q.shape[:2]
    n_rep = cfg.num_heads // cfg.num_kv_heads
    o = full_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                       causal=False, kv_len_mask=live)
    return o.reshape(b_, nq, cfg.num_heads * cfg.resolved_head_dim)


def paged_write_slot(idx: torch.Tensor, block_tables: torch.Tensor,
                     block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical block, in-block offset) for each write position.

    ``idx`` is [B] (one write per slot) or [B, W] (the chunk lanes).  A
    position past the slot's addressable range (cache full, finished slot,
    dead lane) goes to the null block.
    """
    t_max = block_tables.shape[1] * block_size
    safe = idx.clamp(max=t_max - 1).long()
    col = safe // block_size
    if idx.dim() == 1:
        blk = block_tables.gather(1, col[:, None])[:, 0]
    else:
        blk = block_tables.gather(1, col)
    blk = torch.where(idx < t_max, blk, NULL_BLOCK)
    return blk.long(), safe % block_size


def _gather_view(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """[NB, bs, kv, hd] pool -> [B, nblk * bs, kv, hd] sequence-major view."""
    b_, nblk = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(b_, nblk * pool.shape[1], *pool.shape[2:])


def gqa_decode_paged(x: torch.Tensor, p, cfg: ArchConfig, k_pool, v_pool,
                     idx: torch.Tensor, block_tables: torch.Tensor, *,
                     impl: str, mm: str) -> torch.Tensor:
    """One-token decode: write the new K/V rows into the pool in place,
    attend over the slot's blocks.  ``idx`` [B] is each slot's write
    position; ``impl`` is "gather" or "pallas" (the hand-written kernel)."""
    b_ = x.shape[0]
    bs = k_pool.shape[1]
    q, k_new, v_new = gqa_qkv(x, p, cfg, idx[:, None], mm)
    blk, off = paged_write_slot(idx, block_tables, bs)
    k_pool.index_put_((blk, off), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new[:, 0].to(v_pool.dtype))
    t_max = block_tables.shape[1] * bs
    if impl == "pallas":
        lengths = (idx + 1).clamp(max=t_max).to(torch.int32)
        o = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                   block_tables, lengths)
        o = o.reshape(b_, 1, -1)
    elif impl == "gather":
        live = torch.arange(t_max, device=x.device)[None, :] <= idx[:, None]
        o = _gqa_attend(q, _gather_view(k_pool, block_tables),
                        _gather_view(v_pool, block_tables), live, cfg)
    else:
        raise ValueError(f"unknown paged_attn_impl {impl!r}")
    return apply_dense(o, p.wo, mm)


def gqa_mixed_paged(x: torch.Tensor, p, cfg: ArchConfig, k_pool, v_pool,
                    start: torch.Tensor, n_live: torch.Tensor,
                    block_tables: torch.Tensor, *, impl: str,
                    mm: str) -> torch.Tensor:
    """W-lane chunk/decode attention against the pool: lane ``l`` of slot
    ``b`` sits at position ``start[b] + l``; only its first ``n_live[b]``
    lanes are real.  The chunk's K/V are written before the attend (dead
    lanes into the null block)."""
    b_, w, _ = x.shape
    bs = k_pool.shape[1]
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q, k_new, v_new = gqa_qkv(x, p, cfg, positions, mm)
    t_max = block_tables.shape[1] * bs
    idx_w = torch.where(masking.lane_mask(w, n_live), positions, t_max)
    blk, off = paged_write_slot(idx_w, block_tables, bs)
    k_pool.index_put_((blk, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.to(v_pool.dtype))
    if impl == "pallas":
        o = chunked_prefill_attention(q.contiguous(), k_pool, v_pool,
                                      block_tables, start.to(torch.int32))
        o = o.reshape(b_, w, -1)
    elif impl == "gather":
        live = masking.chunk_causal_mask(t_max, start, w)
        o = _gqa_attend(q, _gather_view(k_pool, block_tables),
                        _gather_view(v_pool, block_tables), live, cfg)
    else:
        raise ValueError(f"unknown paged_attn_impl {impl!r}")
    return apply_dense(o, p.wo, mm)
