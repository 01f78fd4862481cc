"""Attention of the port: GQA and MLA, each full-sequence, as the paged
decode, the paged mixed (chunk) step, and the mixed step over a dense
per-slot cache (the speculation draft's).

The counterpart of the reference's ``models/attention.py``.  The
dtype flow is the reference's: scores are an einsum in the promoted
operand dtype, softmax in float32, and the probabilities are cast to V's
dtype before the PV product.

The paged pool is updated **in place** (``core.kv_quant.cache_put``): the
reference donates the cache to its jitted step, the port writes the new
K/V rows (and, with the int8 codec, their scales) straight into the pool
tensors.  Writes past a slot's blocks and writes of dead lanes are routed
to the null block explicitly; in a dense cache they go to its spare row.  With the int8 codec the gather path
dequantizes the gathered view to x's dtype and the kernels take the
scales.

MLA (DeepSeek-V3) caches one compressed latent ``c_kv`` [rank] and one
shared rope key ``k_rope`` per position (``MLACache``), paged through the
same block tables and codec (the int8 codec: one float32 scale per cached
position and tensor).  Decode and the chunk step attend with the absorbed
contraction (``_mla_attend``, the reference's: ``k_up`` folded into the
query in float32, scores in float32, the latent attend in the stored
dtype, one ``v_up`` expansion) over the gathered latent view; the
reference has no Pallas kernel there, so neither has the port.  The
projections go through ``apply_dense`` (the matmul kernels under
``"pallas"``) and ``q_norm`` / ``kv_norm`` through ``apply_norm`` (the
``rmsnorm`` kernel under ``"pallas"``).
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
from repro_torch.models.layers import apply_dense, apply_norm, apply_rope

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


def gqa_mixed(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
              start: torch.Tensor, n_live: torch.Tensor, *,
              mm: str) -> torch.Tensor:
    """W-lane chunk/decode attention against one layer's dense cache
    ``[B, max_len + 1, kv, hd]`` (``Model.init_dense_cache``; float
    storage): lane ``l`` of slot ``b`` sits at position ``start[b] + l``
    and only its first ``n_live[b]`` lanes are real.  The chunk's K/V are
    written before the attend, so one mask (``chunk_causal_mask`` over the
    first ``max_len`` rows) covers the chunk's own causality and the prior
    cache.  Dead lanes and positions past ``max_len - 1`` write into the
    spare row ``max_len``, which no mask admits (the reference drops them
    as out-of-bounds scatters); live lanes never share a row."""
    b_, w, _ = x.shape
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q, k_new, v_new = gqa_qkv(x, p, cfg, positions, mm)
    s_max = cache.k.shape[1] - 1
    live_w = masking.lane_mask(w, n_live) & (positions < s_max)
    idx = (torch.arange(b_, device=x.device)[:, None],
           torch.where(live_w, positions, s_max).long())
    cache.k.index_put_(idx, k_new.to(cache.k.dtype))
    cache.v.index_put_(idx, v_new.to(cache.v.dtype))
    live = masking.chunk_causal_mask(s_max, start, w)
    o = _gqa_attend(q, cache.k[:, :s_max].to(x.dtype),
                    cache.v[:, :s_max].to(x.dtype), live, cfg)
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


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------
class MLACache(NamedTuple):
    """The latent cache: the compressed kv ``c_kv`` and the shared rope key
    ``k_rope``, paged ``[layers, pool_blocks, block_size, rank | rope]``
    (pool row 0 the null block) or dense ``[layers, batch, max_len + 1,
    ...]`` (a draft's; row ``max_len`` the spare), and with the int8 codec
    their float32 scales ``[layers, pool_blocks, block_size]`` (None
    otherwise)."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    c_scale: torch.Tensor | None = None
    r_scale: torch.Tensor | None = None

    def layer(self, i: int) -> "MLACache":
        """Layer ``i``'s views."""
        return MLACache(*(None if t is None else t[i] for t in self))


def _mla_q(x: torch.Tensor, p, cfg: ArchConfig, positions: torch.Tensor,
           mm: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B, S, h, nope], q_rope [B, S, h, rope]) through the query's
    low-rank path: q_down, q_norm, q_up, rope on the rope half."""
    m = cfg.mla
    b_, s, _ = x.shape
    cq = apply_norm(apply_dense(x, p.q_down, mm), p.q_norm, "rmsnorm", mm)
    q = apply_dense(cq, p.q_up, mm).reshape(b_, s, cfg.num_heads,
                                            m.qk_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(x: torch.Tensor, p, cfg: ArchConfig,
                positions: torch.Tensor, mm: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(c_kv [B, S, rank], k_rope [B, S, rope]): kv_down, kv_norm on the
    latent half, rope on the shared key half."""
    m = cfg.mla
    b_, s, _ = x.shape
    full = apply_dense(x, p.kv_down, mm)
    c_kv = apply_norm(full[..., :m.kv_lora_rank].contiguous(), p.kv_norm,
                      "rmsnorm", mm)
    k_rope = full[..., m.kv_lora_rank:].reshape(b_, s, 1, m.qk_rope_head_dim)
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]


def mla_attention(x: torch.Tensor, p, cfg: ArchConfig,
                  positions: torch.Tensor, mm: str) -> torch.Tensor:
    """Full-sequence causal MLA (the forward pass): the latents expanded to
    per-head K/V (the reference's naive path)."""
    m, h = cfg.mla, cfg.num_heads
    b_, s, _ = x.shape
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_kv, k_rope = _mla_latent(x, p, cfg, positions, mm)
    k_nope = apply_dense(c_kv, p.k_up, mm).reshape(b_, s, h,
                                                   m.qk_nope_head_dim)
    v = apply_dense(c_kv, p.v_up, mm).reshape(b_, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        b_, s, h, m.qk_rope_head_dim)], dim=-1)
    o = full_attention(q, k, v, causal=True,
                       scale=1.0 / math.sqrt(m.qk_head_dim))
    return apply_dense(o.reshape(b_, s, h * m.v_head_dim), p.wo, mm)


def _mla_attend(x: torch.Tensor, p, cfg: ArchConfig, q_nope: torch.Tensor,
                q_rope: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor, live: torch.Tensor,
                mm: str) -> torch.Tensor:
    """The absorbed contraction over a sequence-major latent view (c_kv
    [B, T, rank], k_rope [B, T, rope], as stored or dequantized; ``live``
    [B, 1, W, T]): ``k_up`` folded into the query in float32, the scores
    in float32, softmax, the latent attend in c_kv's dtype, then one
    ``v_up`` expansion in x's dtype and ``wo``."""
    m, h = cfg.mla, cfg.num_heads
    b_, w = q_nope.shape[:2]
    wk = p.k_up.kernel.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), wk.float())
    s_lat = torch.einsum("bqhl,bkl->bhqk", q_lat, c_kv.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) / math.sqrt(m.qk_head_dim)
    pr = torch.softmax(torch.where(live, scores, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhqk,bkl->bqhl", pr.to(c_kv.dtype), c_kv)
    wv = p.v_up.kernel.reshape(m.kv_lora_rank, h, m.v_head_dim) \
        .permute(1, 0, 2).to(x.dtype)
    o = torch.einsum("bqhl,hld->bqhd", *_promote(o_lat, wv))
    return apply_dense(o.reshape(b_, w, h * m.v_head_dim), p.wo, mm)


def _mla_write(cache: MLACache, codec: CacheCodec, where: tuple,
               c_new: torch.Tensor, kr_new: torch.Tensor) -> None:
    """Encode the new latents and write values (+ scales) in place."""
    cq, cs = codec.store(c_new, cache.c_kv.dtype)
    rq, rs = codec.store(kr_new, cache.k_rope.dtype)
    cache_put(cache.c_kv, cache.c_scale, where, cq, cs)
    cache_put(cache.k_rope, cache.r_scale, where, rq, rs)


def _mla_gather(cache: MLACache, codec: CacheCodec,
                block_tables: torch.Tensor, dtype: torch.dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return (gather_view(codec, cache.c_kv, cache.c_scale, block_tables,
                        dtype),
            gather_view(codec, cache.k_rope, cache.r_scale, block_tables,
                        dtype))


def mla_decode_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: MLACache,
                     idx: torch.Tensor, block_tables: torch.Tensor, *,
                     mm: str, codec: CacheCodec = FLOAT_CODEC
                     ) -> torch.Tensor:
    """One-token MLA decode against one layer's latent pool: write the new
    latents at ``idx`` [B] in place, attend over the slot's blocks."""
    bs = cache.c_kv.shape[1]
    positions = idx[:, None]
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_new, kr_new = _mla_latent(x, p, cfg, positions, mm)
    _mla_write(cache, codec, paged_write_slot(idx, block_tables, bs),
               c_new[:, 0], kr_new[:, 0])
    t_max = block_tables.shape[1] * bs
    live = (torch.arange(t_max, device=x.device)[None, :]
            <= idx[:, None])[:, None, None, :]
    return _mla_attend(x, p, cfg, q_nope, q_rope,
                       *_mla_gather(cache, codec, block_tables, x.dtype),
                       live, mm)


def mla_mixed_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: MLACache,
                    start: torch.Tensor, n_live: torch.Tensor,
                    block_tables: torch.Tensor, *, mm: str,
                    codec: CacheCodec = FLOAT_CODEC) -> torch.Tensor:
    """W-lane chunk/decode MLA against one layer's latent pool (the lane
    protocol of ``gqa_mixed_paged``): the chunk's latents are written
    before the attend, dead lanes into the null block."""
    b_, w, _ = x.shape
    bs = cache.c_kv.shape[1]
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_new, kr_new = _mla_latent(x, p, cfg, positions, mm)
    t_max = block_tables.shape[1] * bs
    idx_w = torch.where(masking.lane_mask(w, n_live), positions, t_max)
    _mla_write(cache, codec, paged_write_slot(idx_w, block_tables, bs),
               c_new, kr_new)
    live = masking.chunk_causal_mask(t_max, start, w)[:, None]
    return _mla_attend(x, p, cfg, q_nope, q_rope,
                       *_mla_gather(cache, codec, block_tables, x.dtype),
                       live, mm)


def mla_mixed(x: torch.Tensor, p, cfg: ArchConfig, cache: MLACache,
              start: torch.Tensor, n_live: torch.Tensor, *,
              mm: str) -> torch.Tensor:
    """W-lane chunk/decode MLA against one layer's dense latent cache
    ``[B, max_len + 1, ...]`` (``Model.init_dense_cache``, float storage;
    the lane protocol of ``gqa_mixed``): dead lanes and positions past
    ``max_len - 1`` write into the spare row, which no mask admits."""
    b_, w, _ = x.shape
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_new, kr_new = _mla_latent(x, p, cfg, positions, mm)
    s_max = cache.c_kv.shape[1] - 1
    live_w = masking.lane_mask(w, n_live) & (positions < s_max)
    where = (torch.arange(b_, device=x.device)[:, None],
             torch.where(live_w, positions, s_max).long())
    _mla_write(cache, FLOAT_CODEC, where, c_new, kr_new)
    live = masking.chunk_causal_mask(s_max, start, w)[:, None]
    return _mla_attend(x, p, cfg, q_nope, q_rope, cache.c_kv[:, :s_max],
                       cache.k_rope[:, :s_max], live, mm)
