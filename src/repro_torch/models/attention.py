"""Attention of the port: GQA and MLA, each full-sequence, as the prefill
that also emits a layer's dense cache, as the one-token decode and the
mixed (chunk) step over the paged pool or over the dense per-slot cache.

The counterpart of the reference's ``models/attention.py``.  The
dtype flow is the reference's: scores are an einsum in the promoted
operand dtype, softmax in float32, and the probabilities are cast to V's
dtype before the PV product.

The paged pool is updated **in place** (``core.kv_quant.cache_put``): the
reference donates the cache to its jitted step, the port writes the new
K/V rows (and, with the int8 codec, their scales) straight into the pool
tensors.  Writes past a slot's blocks and writes of dead lanes are routed
to the null block explicitly.  A dense cache ``[B, max_len + 1, ...]``
holds one spare row past the end that takes the writes of dead lanes and
of positions past ``max_len - 1`` (the reference drops them as
out-of-bounds scatters) and that no mask admits.  With the int8 codec
the gather path dequantizes the gathered view to x's dtype and the
kernels take the scales; the dense cache is read through ``codec.load``
(as stored in compute mode, dequantized to x's dtype under int8).

The full-sequence attention of ``forward`` and of the prefill is plain
PyTorch, as the reference's is XLA: with a window (the hybrid family's
local attention) ``local_attention`` where the sequence is longer than
the window, else ``full_attention`` below ``BLOCKWISE_THRESHOLD``
positions and ``blockwise_attention`` (query blocks of ``QUERY_BLOCK``,
exact) at or above it.  A windowed layer's decode cache is a rolling
buffer of ``w = min(window, max_len)`` bf16 rows (no spare row, never
quantized): row ``p % w`` holds position ``p``.

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

Under tensor parallelism (``models/tensor_parallel.py``) each rank runs
the GQA decode and chunk steps over its own heads: ``heads`` (a
``HeadShard``) gives the rank's query and kv head counts, and where the
kv heads are whole on every rank while the query heads split, the kv
head of each of its query heads.
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

# Sequences at or above this length use blockwise (streamed) attention;
# below it the direct einsum chain (the reference's rule).
BLOCKWISE_THRESHOLD = 8_192
QUERY_BLOCK = 1_024


class KVCache(NamedTuple):
    """The paged pool ``[layers, pool_blocks, block_size, kv, hd]`` K and V
    (pool row 0 is the null block) or the dense cache ``[layers, batch,
    max_len + 1, kv, hd]`` (row ``max_len`` the spare), and with the int8
    codec their float32 scales, the values' shape without the last dim
    (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    def layer(self, i: int) -> "KVCache":
        """Layer ``i``'s views ``[pool_blocks, block_size, ...]``."""
        return KVCache(*(None if t is None else t[i] for t in self))


class HeadShard(NamedTuple):
    """One tensor-parallel rank's share of a GQA layer: its query heads,
    the kv heads it holds, and, where those do not take the query heads
    in equal groups (every kv head on every rank, the query heads split),
    the index of each query head's kv head among them ([heads] int64 on
    the rank's device; None for the plain grouping)."""

    heads: int
    kv_heads: int
    kv_map: torch.Tensor | None = None


def _heads(cfg: ArchConfig, heads: HeadShard | None) -> HeadShard:
    return HeadShard(cfg.num_heads, cfg.num_kv_heads) if heads is None \
        else heads


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


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        query_block: int = QUERY_BLOCK,
                        scale: float | None = None) -> torch.Tensor:
    """Query-block streamed attention (exact): the score rows of one block
    of ``query_block`` queries at a time, so the peak score memory is
    B x h x query_block x Skv.  q: [B, Sq, h, hd], k: [B, Skv, h, hd],
    v: [B, Skv, h, vd] (MLA's value dim may differ)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    nb = -(-sq // query_block)
    pad = nb * query_block - sq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    kv_pos = torch.arange(skv, device=q.device)
    out = []
    for i in range(nb):
        qi = q[:, i * query_block:(i + 1) * query_block]
        qs, ks = _promote(qi, k)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, ks).float() * scale
        if causal:
            q_pos = i * query_block + torch.arange(query_block,
                                                   device=q.device)
            m = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(m[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    return torch.cat(out, dim=1)[:, :sq]


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, *, scale: float | None = None
                    ) -> torch.Tensor:
    """Causal banded attention: position i attends to (i - window, i].

    Block-wise with blocks of ``window`` queries, as the reference: each
    query block attends to its own and the previous key block (block -1
    is zeros and fully masked), so the scores take B x h x S x 2w, never
    S^2.  q: [B, S, h, hd], k/v: [B, S, h, hd] (kv already repeated)."""
    b, s, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    w = min(window, s)
    nb = -(-s // w)
    pad = nb * w - s
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    qb, kb, vb = (t.reshape(b, nb, w, h, t.shape[-1]) for t in (q, k, v))
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                       # [b, nb, 2w, h, hd]
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    sc = torch.einsum("bnqhd,bnkhd->bnhqk", *_promote(qb, k2)).float() \
        * scale
    q_pos = torch.arange(w, device=q.device)[:, None] + w
    kv_pos = torch.arange(2 * w, device=q.device)[None, :]
    m = (kv_pos <= q_pos) & (kv_pos > q_pos - w)        # (i - w, i]
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    m = m[None] & (~first | (kv_pos[None] >= w))        # block -1 invalid
    p = torch.softmax(torch.where(m[:, None], sc, NEG_INF), dim=-1)
    ob = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(v2.dtype), v2)
    return ob.reshape(b, nb * w, h, v.shape[-1])[:, :s]


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float | None = None, window: int | None = None,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (the reference's choice), causal unless
    told otherwise (an encoder's): banded where a ``window`` is shorter
    than the sequence, else blockwise at ``BLOCKWISE_THRESHOLD`` positions
    and past, else direct."""
    if window is not None and q.shape[1] > window:
        return local_attention(q, k, v, window, scale=scale)
    if q.shape[1] >= BLOCKWISE_THRESHOLD:
        return blockwise_attention(q, k, v, causal=causal, scale=scale)
    return full_attention(q, k, v, causal=causal, scale=scale)


def gqa_qkv(x: torch.Tensor, p, cfg: ArchConfig, positions: torch.Tensor,
            mm: str, heads: HeadShard | None = None):
    b_, s, _ = x.shape
    h, kv, _ = _heads(cfg, heads)
    hd = cfg.resolved_head_dim
    q = apply_dense(x, p.wq, mm).reshape(b_, s, h, hd)
    k = apply_dense(x, p.wk, mm).reshape(b_, s, kv, hd)
    v = apply_dense(x, p.wv, mm).reshape(b_, s, kv, hd)
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(x: torch.Tensor, p, cfg: ArchConfig, positions, mm: str,
                  window: int | None = None,
                  causal: bool = True) -> torch.Tensor:
    """Full-sequence GQA attention (the forward pass), causal but in an
    encoder; ``window``: the hybrid family's local attention."""
    return _gqa_full(x, p, cfg, positions, mm, window, causal)[0]


def _gqa_full(x: torch.Tensor, p, cfg: ArchConfig, positions, mm: str,
              window: int | None = None, causal: bool = True):
    """(output, k, v) of full-sequence GQA attention."""
    b_, s, _ = x.shape
    q, k, v = gqa_qkv(x, p, cfg, positions, mm)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    o = _attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                   window=window, causal=causal)
    return apply_dense(o.reshape(b_, s, -1), p.wo, mm), k, v


def padded_store(codec: CacheCodec, x: torch.Tensor, max_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The codec's stored rows of x [B, S, ...] (bf16 values, or int8 with
    their scales), zero-padded along S to ``max_len`` rows."""
    q, sc = codec.store(x, torch.bfloat16)
    pad = max_len - x.shape[1]
    q = torch.nn.functional.pad(q, (0, 0) * (q.dim() - 2) + (0, pad))
    if sc is not None:
        sc = torch.nn.functional.pad(sc, (0, 0) * (sc.dim() - 2) + (0, pad))
    return q, sc


def rolling_rows(x: torch.Tensor, lengths: torch.Tensor | None,
                 w: int) -> torch.Tensor:
    """The rolling buffer [B, w, ...] (bf16) of x [B, S, ...]: row r holds
    the last position p < length with p % w == r, zeros where there is
    none (``lengths`` [B], or S for every row).  Static shapes: one graph
    serves every length of a bucket."""
    b_, s = x.shape[:2]
    last = (torch.full((b_,), s, device=x.device) if lengths is None
            else lengths).long()[:, None] - 1
    pos = last - (last - torch.arange(w, device=x.device)[None, :]) % w
    idx = pos.clamp(min=0).reshape(b_, w, *(1,) * (x.dim() - 2))
    rows = x.gather(1, idx.expand(b_, w, *x.shape[2:]))
    live = (pos >= 0).reshape(idx.shape)
    return torch.where(live, rows, 0).to(torch.bfloat16)


def gqa_prefill(x: torch.Tensor, p, cfg: ArchConfig, positions, *,
                max_len: int, mm: str, codec: CacheCodec = FLOAT_CODEC,
                window: int | None = None,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also emits this layer's dense cache
    ``[B, max_len, kv, hd]`` through the codec (rows past the sequence are
    zeros).  With a ``window`` (the hybrid family) the cache is the
    rolling buffer ``[B, min(window, max_len), kv, hd]`` in bf16 (never
    quantized, the reference's rule): row ``p % w`` holds position ``p``
    for ``p`` in ``[max(0, len - w), len)``, ``len`` each row's entry of
    ``lengths`` (real positions of a right-padded prompt; S by default)."""
    o, k, v = _gqa_full(x, p, cfg, positions, mm, window)
    if window is not None:
        if codec.quantized:
            raise ValueError("kv_dtype='int8' is unsupported for "
                             "rolling-window attention caches")
        w = min(window, max_len)
        return o, KVCache(rolling_rows(k, lengths, w),
                          rolling_rows(v, lengths, w))
    kq, ks = padded_store(codec, k, max_len)
    vq, vs = padded_store(codec, v, max_len)
    return o, KVCache(kq, vq, ks, vs)


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                live: torch.Tensor, cfg: ArchConfig,
                heads: HeadShard | None = None) -> torch.Tensor:
    """Masked attention over a sequence-major [B, S, kv, hd] view."""
    b_, nq = q.shape[:2]
    h, kv, kv_map = _heads(cfg, heads)
    if kv_map is None:
        k, v = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
    else:
        k, v = k.index_select(2, kv_map), v.index_select(2, kv_map)
    o = full_attention(q, k, v, causal=False, kv_len_mask=live)
    return o.reshape(b_, nq, h * cfg.resolved_head_dim)


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
                   live, cfg: ArchConfig,
                   heads: HeadShard | None = None) -> torch.Tensor:
    return _gqa_attend(
        q, gather_view(codec, cache.k, cache.k_scale, block_tables, q.dtype),
        gather_view(codec, cache.v, cache.v_scale, block_tables, q.dtype),
        live, cfg, heads)


def gqa_decode_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
                     idx: torch.Tensor, block_tables: torch.Tensor, *,
                     impl: str, mm: str, codec: CacheCodec = FLOAT_CODEC,
                     heads: HeadShard | None = None) -> torch.Tensor:
    """One-token decode against one layer's pool ``cache``: write the new
    K/V rows into it in place, attend over the slot's blocks.  ``idx`` [B]
    is each slot's write position; ``impl`` is "gather" or "pallas" (the
    hand-written kernel)."""
    b_ = x.shape[0]
    bs = cache.k.shape[1]
    q, k_new, v_new = gqa_qkv(x, p, cfg, idx[:, None], mm, heads)
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
        o = _gather_attend(q, cache, codec, block_tables, live, cfg, heads)
    else:
        raise ValueError(f"unknown paged_attn_impl {impl!r}")
    return apply_dense(o, p.wo, mm)


def dense_write_slot(idx: torch.Tensor, live: torch.Tensor,
                     s_max: int) -> tuple:
    """(slot, position) of each write into a dense cache whose spare row is
    ``s_max``: the live writes below ``s_max`` at their position, the rest
    at the spare row.  ``idx`` is [B] or [B, W]."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    if idx.dim() == 2:
        rows = rows[:, None]
    return rows, torch.where(live & (idx < s_max), idx, s_max).long()


def _dense_view(t: torch.Tensor, scale: torch.Tensor | None,
                codec: CacheCodec, s_max: int, dtype) -> torch.Tensor:
    """The first ``s_max`` rows of one dense cache tensor, read through the
    codec (as stored, or dequantized to ``dtype``)."""
    return codec.load(t[:, :s_max], None if scale is None
                      else scale[:, :s_max], dtype)


def gqa_decode(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
               idx: torch.Tensor, *, mm: str,
               codec: CacheCodec = FLOAT_CODEC,
               window: int | None = None,
               heads: HeadShard | None = None) -> torch.Tensor:
    """One-token decode against one layer's dense cache ``[B, max_len + 1,
    kv, hd]``: write the new K/V rows at ``idx`` [B] (the spare row from
    ``max_len`` on) in place, attend over positions ``<= idx``.  With a
    ``window`` the cache is the rolling buffer ``[B, w, kv, hd]``: the new
    row goes to ``idx % w``, and a row is live where it is at most that
    slot or the buffer has wrapped (``idx >= w``)."""
    q, k_new, v_new = gqa_qkv(x, p, cfg, idx[:, None], mm, heads)
    if window is not None:
        w = cache.k.shape[1]
        slot = (idx % w).long()
        _write(cache, codec, (torch.arange(idx.shape[0], device=x.device),
                              slot), k_new[:, 0], v_new[:, 0])
        live = (torch.arange(w, device=x.device)[None, :] <= slot[:, None]) \
            | (idx[:, None] >= w)
        o = _gqa_attend(q, cache.k, cache.v, live, cfg, heads)
        return apply_dense(o, p.wo, mm)
    s_max = cache.k.shape[1] - 1
    every = torch.ones_like(idx, dtype=torch.bool)
    _write(cache, codec, dense_write_slot(idx, every, s_max), k_new[:, 0],
           v_new[:, 0])
    live = torch.arange(s_max, device=x.device)[None, :] <= idx[:, None]
    o = _gqa_attend(q, _dense_view(cache.k, cache.k_scale, codec, s_max,
                                   x.dtype),
                    _dense_view(cache.v, cache.v_scale, codec, s_max,
                                x.dtype), live, cfg, heads)
    return apply_dense(o, p.wo, mm)


def gqa_mixed(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
              start: torch.Tensor, n_live: torch.Tensor, *,
              mm: str, codec: CacheCodec = FLOAT_CODEC,
              heads: HeadShard | None = None) -> torch.Tensor:
    """W-lane chunk/decode attention against one layer's dense cache
    ``[B, max_len + 1, kv, hd]`` (``Model.init_cache`` without paging, or a
    draft's ``init_dense_cache``): lane ``l`` of slot ``b`` sits at
    position ``start[b] + l`` and only its first ``n_live[b]`` lanes are
    real.  The chunk's K/V are written before the attend, so one mask
    (``chunk_causal_mask`` over the first ``max_len`` rows) covers the
    chunk's own causality and the prior cache.  Dead lanes and positions
    past ``max_len - 1`` write into the spare row, which no mask admits;
    live lanes never share a row."""
    b_, w, _ = x.shape
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q, k_new, v_new = gqa_qkv(x, p, cfg, positions, mm, heads)
    s_max = cache.k.shape[1] - 1
    _write(cache, codec, dense_write_slot(
        positions, masking.lane_mask(w, n_live), s_max), k_new, v_new)
    live = masking.chunk_causal_mask(s_max, start, w)
    o = _gqa_attend(q, _dense_view(cache.k, cache.k_scale, codec, s_max,
                                   x.dtype),
                    _dense_view(cache.v, cache.v_scale, codec, s_max,
                                x.dtype), live, cfg, heads)
    return apply_dense(o, p.wo, mm)


def gqa_mixed_paged(x: torch.Tensor, p, cfg: ArchConfig, cache: KVCache,
                    start: torch.Tensor, n_live: torch.Tensor,
                    block_tables: torch.Tensor, *, impl: str, mm: str,
                    codec: CacheCodec = FLOAT_CODEC,
                    heads: HeadShard | None = None) -> torch.Tensor:
    """W-lane chunk/decode attention against one layer's pool ``cache``:
    lane ``l`` of slot ``b`` sits at position ``start[b] + l``; only its
    first ``n_live[b]`` lanes are real.  The chunk's K/V are written before
    the attend (dead lanes into the null block)."""
    b_, w, _ = x.shape
    bs = cache.k.shape[1]
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q, k_new, v_new = gqa_qkv(x, p, cfg, positions, mm, heads)
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
        o = _gather_attend(q, cache, codec, block_tables, live, cfg, heads)
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
    ...]`` (row ``max_len`` the spare), and with the int8 codec their
    float32 scales, the values' shape without the last dim (None
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
    return _mla_full(x, p, cfg, positions, mm)[0]


def _mla_full(x: torch.Tensor, p, cfg: ArchConfig, positions: torch.Tensor,
              mm: str):
    """(output, c_kv, k_rope) of full-sequence causal MLA."""
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
    o = _attention(q, k, v, scale=1.0 / math.sqrt(m.qk_head_dim))
    return (apply_dense(o.reshape(b_, s, h * m.v_head_dim), p.wo, mm),
            c_kv, k_rope)


def mla_prefill(x: torch.Tensor, p, cfg: ArchConfig, positions, *,
                max_len: int, mm: str, codec: CacheCodec = FLOAT_CODEC
                ) -> tuple[torch.Tensor, MLACache]:
    """MLA prefill: the attention output and this layer's dense latent
    cache ``[B, max_len, rank | rope]`` through the codec (the reference
    computes the latents a second time for the cache; they are the same
    numbers, so the port keeps the ones the attention used)."""
    o, c_kv, k_rope = _mla_full(x, p, cfg, positions, mm)
    cq, cs = padded_store(codec, c_kv, max_len)
    rq, rs = padded_store(codec, k_rope, max_len)
    return o, MLACache(cq, rq, cs, rs)


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


def mla_decode(x: torch.Tensor, p, cfg: ArchConfig, cache: MLACache,
               idx: torch.Tensor, *, mm: str,
               codec: CacheCodec = FLOAT_CODEC) -> torch.Tensor:
    """One-token MLA decode against one layer's dense latent cache ``[B,
    max_len + 1, ...]``: write the new latents at ``idx`` [B] (the spare
    row from ``max_len`` on) in place, attend over positions ``<= idx``."""
    positions = idx[:, None]
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_new, kr_new = _mla_latent(x, p, cfg, positions, mm)
    s_max = cache.c_kv.shape[1] - 1
    _mla_write(cache, codec, dense_write_slot(
        idx, torch.ones_like(idx, dtype=torch.bool), s_max), c_new[:, 0],
        kr_new[:, 0])
    live = (torch.arange(s_max, device=x.device)[None, :]
            <= idx[:, None])[:, None, None, :]
    return _mla_attend(
        x, p, cfg, q_nope, q_rope,
        _dense_view(cache.c_kv, cache.c_scale, codec, s_max, x.dtype),
        _dense_view(cache.k_rope, cache.r_scale, codec, s_max, x.dtype),
        live, mm)


def mla_mixed(x: torch.Tensor, p, cfg: ArchConfig, cache: MLACache,
              start: torch.Tensor, n_live: torch.Tensor, *,
              mm: str, codec: CacheCodec = FLOAT_CODEC) -> torch.Tensor:
    """W-lane chunk/decode MLA against one layer's dense latent cache
    ``[B, max_len + 1, ...]`` (the lane protocol of ``gqa_mixed``): dead
    lanes and positions past ``max_len - 1`` write into the spare row,
    which no mask admits."""
    b_, w, _ = x.shape
    positions = start[:, None] + torch.arange(w, device=x.device,
                                              dtype=start.dtype)[None, :]
    q_nope, q_rope = _mla_q(x, p, cfg, positions, mm)
    c_new, kr_new = _mla_latent(x, p, cfg, positions, mm)
    s_max = cache.c_kv.shape[1] - 1
    _mla_write(cache, codec, dense_write_slot(
        positions, masking.lane_mask(w, n_live), s_max), c_new, kr_new)
    live = masking.chunk_causal_mask(s_max, start, w)[:, None]
    return _mla_attend(
        x, p, cfg, q_nope, q_rope,
        _dense_view(cache.c_kv, cache.c_scale, codec, s_max, x.dtype),
        _dense_view(cache.k_rope, cache.r_scale, codec, s_max, x.dtype),
        live, mm)
