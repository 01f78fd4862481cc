"""GQA attention of the port: full-sequence, paged decode and the paged
mixed (chunk) step.

The counterpart of the reference's ``models/attention.py`` GQA half.  The
dtype flow is the reference's: scores are an einsum in the promoted
operand dtype, softmax in float32, and the probabilities are cast to V's
dtype before the PV product.

The paged pool is updated **in place** (``core.kv_quant.cache_put``): the
reference donates the cache to its jitted step, the port writes the new
K/V rows (and, with the int8 codec, their scales) straight into the pool
tensors.  Writes past a slot's blocks and writes of dead lanes are routed
to the null block explicitly.  With the int8 codec the gather path
dequantizes the gathered view to x's dtype and the kernels take the
scales.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import masking
from repro_torch.core.kv_quant import (FLOAT_CODEC, CacheCodec, cache_put,
                                       gather_view)
from repro_torch.core.paging import NULL_BLOCK
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.layers import apply_dense, apply_rope

NEG_INF = -0.7 * torch.finfo(torch.float32).max


class KVCache(NamedTuple):
    """The paged pool: ``[layers, pool_blocks, block_size, kv, hd]`` K and V
    (pool row 0 is the null block), and with the int8 codec their float32
    scales ``[layers, pool_blocks, block_size, kv]`` (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    def layer(self, i: int) -> "KVCache":
        """Layer ``i``'s views ``[pool_blocks, block_size, ...]``."""
        return KVCache(*(None if t is None else t[i] for t in self))


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


def _write(cache: KVCache, codec: CacheCodec, where: tuple,
           k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Encode the new K/V rows and write values (+ scales) in place."""
    kq, ks = codec.store(k_new, cache.k.dtype)
    vq, vs = codec.store(v_new, cache.v.dtype)
    cache_put(cache.k, cache.k_scale, where, kq, ks)
    cache_put(cache.v, cache.v_scale, where, vq, vs)


def _gather_attend(q, cache: KVCache, codec: CacheCodec, block_tables,
                   live, cfg: ArchConfig) -> torch.Tensor:
    return _gqa_attend(
        q, gather_view(codec, cache.k, cache.k_scale, block_tables, q.dtype),
        gather_view(codec, cache.v, cache.v_scale, block_tables, q.dtype),
        live, cfg)


def gqa_decode_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
                     idx: torch.Tensor, block_tables: torch.Tensor, *,
                     impl: str, mm: str,
                     codec: CacheCodec = FLOAT_CODEC) -> torch.Tensor:
    """One-token decode against one layer's pool ``cache``: write the new
    K/V rows into it in place, attend over the slot's blocks.  ``idx`` [B]
    is each slot's write position; ``impl`` is "gather" or "pallas" (the
    hand-written kernel)."""
    b_ = x.shape[0]
    bs = cache.k.shape[1]
    q, k_new, v_new = gqa_qkv(x, p, cfg, idx[:, None], mm)
    _write(cache, codec, paged_write_slot(idx, block_tables, bs),
           k_new[:, 0], v_new[:, 0])
    t_max = block_tables.shape[1] * bs
    if impl == "pallas":
        lengths = (idx + 1).clamp(max=t_max).to(torch.int32)
        o = paged_decode_attention(q[:, 0].contiguous(), cache.k, cache.v,
                                   block_tables, lengths,
                                   k_scale=cache.k_scale,
                                   v_scale=cache.v_scale)
        o = o.reshape(b_, 1, -1)
    elif impl == "gather":
        live = torch.arange(t_max, device=x.device)[None, :] <= idx[:, None]
        o = _gather_attend(q, cache, codec, block_tables, live, cfg)
    else:
        raise ValueError(f"unknown paged_attn_impl {impl!r}")
    return apply_dense(o, p.wo, mm)


def gqa_mixed_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
                    start: torch.Tensor, n_live: torch.Tensor,
                    block_tables: torch.Tensor, *, impl: str, mm: str,
                    codec: CacheCodec = FLOAT_CODEC) -> torch.Tensor:
    """W-lane chunk/decode attention against one layer's pool ``cache``:
    lane ``l`` of slot ``b`` sits at position ``start[b] + l``; only its
    first ``n_live[b]`` lanes are real.  The chunk's K/V are written before
    the attend (dead lanes into the null block)."""
    b_, w, _ = x.shape
    bs = cache.k.shape[1]
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q, k_new, v_new = gqa_qkv(x, p, cfg, positions, mm)
    t_max = block_tables.shape[1] * bs
    idx_w = torch.where(masking.lane_mask(w, n_live), positions, t_max)
    _write(cache, codec, paged_write_slot(idx_w, block_tables, bs),
           k_new, v_new)
    if impl == "pallas":
        o = chunked_prefill_attention(q.contiguous(), cache.k, cache.v,
                                      block_tables, start.to(torch.int32),
                                      k_scale=cache.k_scale,
                                      v_scale=cache.v_scale)
        o = o.reshape(b_, w, -1)
    elif impl == "gather":
        live = masking.chunk_causal_mask(t_max, start, w)
        o = _gather_attend(q, cache, codec, block_tables, live, cfg)
    else:
        raise ValueError(f"unknown paged_attn_impl {impl!r}")
    return apply_dense(o, p.wo, mm)
