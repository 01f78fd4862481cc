"""Chunked-prefill attention over the paged pool: the counterpart of the
reference's Pallas ``chunked_prefill_attention``.

Each sequence advances by W query lanes; lane ``l`` sits at cache
position ``start[b] + l`` and sees the pool positions ``<= start[b] + l``
(the chunk's own K/V are written before the call).  A CUDA tensor
launches the hand-written kernel of ``csrc/chunked_prefill.cu``; a CPU
tensor runs ``chunked_prefill_attention_plain``.

An int8 pool comes with ``k_scale``/``v_scale`` ``[NB, bs, kv]`` float32
(the int8 cache codec's per-row scales).  Then, as in the reference, the
pool is dequantized to float32, q is cast to float32, p is not rounded,
and the output is float32 until the one cast to q's dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (16, 32, 64, 128)
# (query dtype, pool dtype) pairs the kernel takes
DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16), (torch.float32, torch.int8),
               (torch.bfloat16, torch.int8))


def chunked_prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    start: torch.Tensor,
                                    scale: float | None = None, *,
                                    k_scale: torch.Tensor | None = None,
                                    v_scale: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the reference kernel's
    numerics: float32 scores, one online-softmax update per pool block
    (running max m, normalizer l, float32 accumulator), p rounded to the
    pool's dtype before the PV product, output in q's dtype.  Pool rows no
    lane of a sequence can see are zeroed before the PV product, as the
    kernel never reads them.  An int8 pool is dequantized to float32 with
    its scales and attended by float32 q (p then stays float32)."""
    if k_scale is not None:
        kd = k_pool.float() * k_scale[..., None]
        vd = v_pool.float() * v_scale[..., None]
        return chunked_prefill_attention_plain(
            q.float(), kd, vd, block_tables, start, scale).to(q.dtype)
    B, W, h, hd = q.shape
    _, bs, kv, _ = k_pool.shape
    n_rep = h // kv
    nblk = block_tables.shape[1]
    t_max = nblk * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = block_tables.long()
    kg = k_pool[idx].reshape(B, t_max, kv, hd).float()
    vg = v_pool[idx].reshape(B, t_max, kv, hd).float()
    pos = torch.arange(t_max, device=q.device)
    lim = start.long()[:, None] + torch.arange(W, device=q.device)[None, :]
    vis = pos[None, None, :] <= lim[:, :, None]                 # [B, W, T]
    seen = pos[None, :] <= lim[:, -1:]                         # [B, T]
    vg = torch.where(seen[:, :, None, None], vg, 0.0)
    qg = q.float().reshape(B, W, kv, n_rep, hd)
    s = torch.einsum("bwgrd,btgd->bgrwt", qg, kg) * scale
    s = torch.where(vis[:, None, None], s, NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (hd,), device=q.device)
    for j in range(nblk):
        sj = s[..., j * bs:(j + 1) * bs]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        pr = p.to(v_pool.dtype).float()
        acc = acc * alpha + torch.einsum("bgrwt,btgd->bgrwd", pr,
                                         vg[:, j * bs:(j + 1) * bs])
        m = m_new
    o = acc / lsum.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, W, h, hd).to(q.dtype)


def check_operands(name: str, q, k_pool, v_pool, block_tables, lens,
                   k_scale=None, v_scale=None):
    """Shape / dtype checks shared by both paged attention wrappers (q is
    [B, W, h, hd] here)."""
    B, _, h, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: k/v pools must share one [NB, bs, kv, hd] "
                         f"shape, got {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)}")
    _, _, kv, pool_hd = k_pool.shape
    if pool_hd != hd or h % kv:
        raise ValueError(f"{name}: q heads {h} x {hd} do not group over the "
                         f"pool's {kv} kv heads x {pool_hd}")
    if k_pool.dtype != v_pool.dtype or \
            (q.dtype, k_pool.dtype) not in DTYPE_PAIRS:
        raise ValueError(f"{name}: (q, pool) dtypes ({q.dtype}, "
                         f"{k_pool.dtype}) not one of {DTYPE_PAIRS}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables must be int32 [B={B}, nblk]")
    if lens.shape != (B,) or lens.dtype != torch.int32:
        raise ValueError(f"{name}: per-sequence positions must be int32 [B]")
    quant = k_pool.dtype == torch.int8
    scales = (k_scale, v_scale)
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError(f"{name}: k_scale and v_scale come with an int8 "
                         "pool and only with one")
    if quant and any(s.shape != k_pool.shape[:3] or s.dtype != torch.float32
                     for s in scales):
        raise ValueError(f"{name}: scales must be float32 "
                         f"{tuple(k_pool.shape[:3])} (one per pool row)")


def launch(name: str, kernel, q, k_pool, v_pool, block_tables, lens, scale,
           extra_dims: tuple[int, ...], k_scale=None, v_scale=None
           ) -> torch.Tensor:
    """Launch one of the two paged attention kernels on CUDA tensors
    (``kernel()`` returns the bound C entry point)."""
    scales = [s for s in (k_scale, v_scale) if s is not None]
    runtime.require_cuda(name, q, k_pool, v_pool, block_tables, lens, *scales)
    runtime.require_contiguous(name, q=q, k_pool=k_pool, v_pool=v_pool,
                               block_tables=block_tables, lens=lens,
                               **dict(zip(("k_scale", "v_scale"), scales)))
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not one of {HEAD_DIMS}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned (rows are "
                         "read as 16-byte vectors)")
    _, bs, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             *(None if s is None else s.data_ptr() for s in (k_scale, v_scale)),
             block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
             *extra_dims, kv, hd, bs, block_tables.shape[1],
             runtime.DTYPE_CODES[q.dtype], runtime.DTYPE_CODES[k_pool.dtype],
             float(scale), runtime.stream_handle(q))
    runtime.check(err, name)
    return out


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("chunked_prefill_attention",
                        [p] * 8 + [i] * 9 + [ctypes.c_float, p])


def chunked_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              start: torch.Tensor, *,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None,
                              scale: float | None = None) -> torch.Tensor:
    """W-lane chunk/decode attention over the pooled KV cache.

    q:            [B, W, h, hd]     lane l sits at cache position start[b] + l
    k/v_pool:     [NB, bs, kv, hd]  the shared block pool (row 0 = null)
    block_tables: [B, nblk] int32   physical block of each logical block
    start:        [B] int32         first lane's cache position per slot
    k/v_scale:    [NB, bs, kv] f32  with an int8 pool only: per-row scales
    -> [B, W, h, hd] in q's dtype

    The caller guarantees table entries lie in [0, NB).
    """
    if q.dim() != 4:
        raise ValueError("chunked_prefill_attention: q must be [B, W, h, hd]")
    check_operands("chunked_prefill_attention", q, k_pool, v_pool,
                   block_tables, start, k_scale, v_scale)
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(
            q, k_pool, v_pool, block_tables, start, scale, k_scale=k_scale,
            v_scale=v_scale)
    B, W, h, _ = q.shape
    out = launch("chunked_prefill_attention", _kernel, q, k_pool, v_pool,
                 block_tables, start, scale, (B, W, h), k_scale, v_scale)
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
