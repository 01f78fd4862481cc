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

``live_kv`` ``[B]`` int32 (multi-topology serving, ``serving/fabric.py``)
gives each sequence's live kv groups: the output of every head of a group
``g >= live_kv[b]`` is exact zeros, whatever q and the pool hold there
(the reference's ``where(g < live_kv[b], out, 0)``).  The kernel's CTAs of
a dead group read nothing; ``apply_live_kv`` is that step in plain
PyTorch.

The kernel (the split-KV walk of ``csrc/split_walk.cuh``, which decode
shares at W = 1) gives each CTA 16 query rows of one (sequence, kv head)
and splits each sequence's block table into key ranges of whole logical
blocks (``kv_splits`` / ``kv_ranges``, from the shapes and the walk's
occupancy, ``resident_ctas``, alone: never from start or the tables);
with more than one range each CTA writes its range's unnormalised
float32 accumulator and running (max, sum) to a workspace, and a merge
kernel combines them.  ``chunked_prefill_partial_plain`` and
``merge_partials_plain`` are those two steps in plain PyTorch.

Every head dim the reference takes (it pads hd to 128 lanes): an hd that
is not a multiple of 16, or is past 128, runs the walk's general bodies,
which stage rows padded to a multiple of 16 with zeros and give each CTA
one group of 128 output columns (``col_groups``: a third grid dimension
beside the row tiles and the key ranges).  The one refusal left is an hd
whose CTA would not fit in shared memory (``check_head_dim``): past 512
for some dtype pairs, never at or below it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime
# the split's merge in plain PyTorch: acc [splits, B, W, h, hd], m and l
# [splits, B, W, h] -> [B, W, h, hd], the same arithmetic as flash's
from repro_torch.kernels.flash_attention import merge_partials_plain  # noqa: F401

NEG_INF = -0.7 * torch.finfo(torch.float32).max
# every dtype pair takes every head dim up to this one (past it, as far as
# one CTA's shared memory holds: check_head_dim)
MAX_HEAD_DIM = 512
TILE_ROWS = 16              # query rows per CTA (one m16 tile)
CTA_SMEM = 227 * 1024       # the shared memory one CTA can have
WARPS = 4                   # a CTA's warps, each with its own ring
GROUP_COLS = 128            # output columns per CTA of the general walk
# (query dtype, pool dtype) pairs the kernels take
DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16), (torch.float32, torch.int8),
               (torch.bfloat16, torch.int8))


def chunked_prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    start: torch.Tensor,
                                    scale: float | None = None, *,
                                    k_scale: torch.Tensor | None = None,
                                    v_scale: torch.Tensor | None = None,
                                    live_kv: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the reference kernel's
    numerics: ``chunked_prefill_partial_plain`` over the whole table
    (float32 scores, one online-softmax update per pool block, p rounded to
    the pool's dtype before PV; an int8 pool dequantized and attended in
    float32), then O = acc / max(l, 1e-30) in q's dtype, and the dead kv
    groups of ``live_kv`` zeroed (``apply_live_kv``).  Block 0 holds
    position 0, which every lane sees, so every row's running max is
    finite from the first block on."""
    acc, _, lsum = chunked_prefill_partial_plain(
        q, k_pool, v_pool, block_tables, start, 0, block_tables.shape[1],
        scale, k_scale=k_scale, v_scale=v_scale)
    out = (acc / lsum.clamp_min(1e-30)[..., None]).to(q.dtype)
    return apply_live_kv(out, live_kv, k_pool.shape[2])


def apply_live_kv(out: torch.Tensor, live_kv: torch.Tensor | None,
                  kv: int) -> torch.Tensor:
    """``out`` ``[B, ..., h, hd]`` with every head of a kv group ``g >=
    live_kv[b]`` set to exact zeros (heads group as ``g = head // n_rep``);
    ``live_kv=None`` leaves it as it is."""
    if live_kv is None:
        return out
    h = out.shape[-2]
    group = torch.arange(h, device=out.device) // (h // kv)
    live = group[None, :] < live_kv[:, None]               # [B, h]
    live = live.reshape(out.shape[0], *[1] * (out.dim() - 3), h, 1)
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def chunked_prefill_partial_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  start: torch.Tensor, lo_blk: int,
                                  hi_blk: int, scale: float | None = None, *,
                                  k_scale: torch.Tensor | None = None,
                                  v_scale: torch.Tensor | None = None
                                  ) -> tuple[torch.Tensor, ...]:
    """The reference kernel's block loop over the logical blocks [lo_blk,
    hi_blk) of each table, one online-softmax update per pool block, p
    rounded to the pool's dtype before PV (an int8 pool: dequantized, f32
    q, f32 p).  Returns the unnormalised float32 accumulator ``[B, W, h,
    hd]`` and the running max and sum ``[B, W, h]``.  A row that sees no
    position of the range keeps m = NEG_INF and l = 0 (p of a masked score
    is 0).  Pool rows no lane of a sequence can see are zeroed before the
    PV product, as the kernel never reads them."""
    if k_scale is not None:
        kd = k_pool.float() * k_scale[..., None]
        vd = v_pool.float() * v_scale[..., None]
        return chunked_prefill_partial_plain(q.float(), kd, vd, block_tables,
                                             start, lo_blk, hi_blk, scale)
    B, W, h, hd = q.shape
    _, bs, kv, _ = k_pool.shape
    n_rep = h // kv
    n = hi_blk - lo_blk
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = block_tables[:, lo_blk:hi_blk].long()
    kg = k_pool[idx].reshape(B, n * bs, kv, hd).float()
    vg = v_pool[idx].reshape(B, n * bs, kv, hd).float()
    pos = lo_blk * bs + torch.arange(n * bs, device=q.device)
    lim = start.long()[:, None] + torch.arange(W, device=q.device)[None, :]
    vis = (pos[None, None, :] <= lim[:, :, None])[:, None, None]  # [B,1,1,W,T]
    seen = pos[None, :] <= lim[:, -1:]                           # [B, T]
    vg = torch.where(seen[:, :, None, None], vg, 0.0)
    qg = q.float().reshape(B, W, kv, n_rep, hd)
    s = torch.einsum("bwgrd,btgd->bgrwt", qg, kg) * scale
    s = torch.where(vis, s, NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (hd,), device=q.device)
    for j in range(n):
        cols = slice(j * bs, (j + 1) * bs)
        sj = s[..., cols]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis[..., cols], torch.exp(sj - m_new), 0.0)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bgrwt,btgd->bgrwd", p.to(v_pool.dtype).float(), vg[:, cols])
        m = m_new
    acc = acc.permute(0, 3, 1, 2, 4).reshape(B, W, h, hd)
    return (acc, m[..., 0].permute(0, 3, 1, 2).reshape(B, W, h),
            lsum[..., 0].permute(0, 3, 1, 2).reshape(B, W, h))


def row_tiles(rows: int) -> int:
    """CTAs per (sequence, kv head): ``rows`` = W * n_rep query rows in
    tiles of 16."""
    return -(-rows // TILE_ROWS)


def kv_splits(B: int, kv: int, rows: int, nblk: int, sms: int,
              resident: int, groups: int = 1) -> int:
    """How many key ranges the kernel's grid takes, from the shapes alone:
    1 where the B * kv * row_tiles(rows) * ``groups`` (column groups) CTAs
    already fill one wave (``resident`` CTAs on each of ``sms`` SMs); else
    about one wave, capped so that every range holds at least two pool
    blocks."""
    ctas = B * kv * row_tiles(rows) * groups
    wave = resident * sms
    if ctas >= wave:
        return 1
    return max(1, min(wave // ctas, nblk // 2))


def general_hd(hd: int) -> bool:
    """True where the walk runs its general bodies (an hd that is not a
    multiple of 16, or is past 128)."""
    return hd % 16 != 0 or hd > 128


def col_groups(hd: int) -> tuple[int, int, int]:
    """The walk's column plan at hd (``plan_general`` in
    ``csrc/split_walk.cuh``): (staged row width KP, columns per CTA GW,
    column groups).  The general bodies stage K rows of KP = hd rounded up
    to 16 and give each CTA GW = 128 output columns (the last group's past
    hd are never written); the hd <= 128 bodies (hd a multiple of 16) take
    hd in one group."""
    if not general_hd(hd):
        return hd, hd, 1
    return -(-hd // 16) * 16, GROUP_COLS, -(-hd // GROUP_COLS)


def walk_smem(hd: int, nblk: int, q_dtype: torch.dtype,
              kv_dtype: torch.dtype, stages: int) -> int:
    """Bytes of shared memory one CTA of the general walk needs at hd
    over ``nblk`` table entries with ``stages`` ring stages
    (``gen_smem_bytes`` in ``csrc/split_walk.cuh``): q rows, the table,
    the warps' rings (at least the partials that reuse them) and the FMA
    body's p."""
    kp, gw, _ = col_groups(hd)
    esz = torch.empty((), dtype=kv_dtype).element_size()
    stage = TILE_ROWS * (kp * esz + 16) + TILE_ROWS * (gw * esz + 16) \
        + 2 * TILE_ROWS * 4
    red = (WARPS * TILE_ROWS * gw + 2 * WARPS * TILE_ROWS) * 4
    fma = (q_dtype, kv_dtype) != (torch.bfloat16, torch.bfloat16)
    return (TILE_ROWS * kp * 4 + -(-(nblk + 1) * 4 // 16) * 16
            + max(WARPS * stages * stage, red)
            + (WARPS * (TILE_ROWS * TILE_ROWS + TILE_ROWS) * 4 if fma else 0))


def walk_stages(hd: int, nblk: int, q_dtype: torch.dtype,
                kv_dtype: torch.dtype) -> int:
    """Ring stages of the general walk at hd: 3 (2 over an f32 pool), fewer
    where a CTA's shared memory would pass 227 KB; 0 where one stage does
    not fit."""
    top = 2 if kv_dtype == torch.float32 else 3
    return next((s for s in range(top, 0, -1)
                 if walk_smem(hd, nblk, q_dtype, kv_dtype, s) <= CTA_SMEM),
                0)


def kv_ranges(nblk: int, splits: int) -> list[tuple[int, int]]:
    """The logical-block ranges [lo, hi) of a split: floor(s * nblk /
    splits) up to floor((s + 1) * nblk / splits), the same ranges the
    kernel computes from its grid index."""
    return [(s * nblk // splits, (s + 1) * nblk // splits)
            for s in range(splits)]


# each entry point's occupancy query (decode compiles its own walk)
RESIDENT_ENTRY = {"chunked_prefill_attention": "chunked_prefill_resident_ctas",
                  "paged_decode_attention": "paged_decode_resident_ctas"}


@functools.cache
def _resident(index: int, kernel: str, q_dtype: torch.dtype,
              kv_dtype: torch.dtype, hd: int, nblk: int) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = runtime.bind(RESIDENT_ENTRY[kernel],
                           [ctypes.c_int] * 4 + [ctypes.c_void_p])(
            hd, nblk, runtime.DTYPE_CODES[q_dtype],
            runtime.DTYPE_CODES[kv_dtype], ctypes.addressof(n))
    runtime.check(err, kernel)
    return max(1, n.value)


def resident_ctas(device: torch.device, q_dtype: torch.dtype,
                  kv_dtype: torch.dtype, hd: int, nblk: int,
                  kernel: str = "chunked_prefill_attention") -> int:
    """The walk's CTAs that fit on one SM of ``device`` for a (q, pool)
    dtype pair at hd and nblk: the CUDA occupancy of ``kernel``'s compiled
    walk (its shared memory, registers and threads), asked once per
    setting."""
    return _resident(device.index if device.index is not None
                     else torch.cuda.current_device(),
                     kernel, q_dtype, kv_dtype, hd, nblk)


def check_head_dim(hd: int, name: str = "chunked_prefill_attention",
                   q_dtype: torch.dtype = torch.float32,
                   kv_dtype: torch.dtype = torch.float32,
                   nblk: int = 1) -> None:
    """The walk takes every hd whose CTA fits in shared memory: every hd
    of the hd <= 128 bodies, and of the general bodies every one at which
    a ring of one stage fits (``walk_stages``; all up to 512 in every
    dtype pair, as far as the table of ``nblk`` entries leaves room)."""
    if hd <= 0:
        raise ValueError(f"{name}: head_dim must be positive, got {hd}")
    if general_hd(hd) and not walk_stages(hd, nblk, q_dtype, kv_dtype):
        need = walk_smem(hd, nblk, q_dtype, kv_dtype, 1)
        raise ValueError(
            f"{name}: at head_dim {hd} ({q_dtype} q over a {kv_dtype} pool, "
            f"{nblk} table entries) one CTA's shared memory would need "
            f"{need} B with a one-stage ring, more than the {CTA_SMEM} B a "
            "CTA can have")


def walk_plan(kernel: str, q: torch.Tensor, k_pool: torch.Tensor,
              block_tables: torch.Tensor):
    """One launch of ``kernel``'s walk for q ``[B, W, h, hd]`` on the card:
    its grid (CTAs: row tiles x column groups, key ranges) from the shapes
    and the walk's occupancy alone, and the float32 workspace of the
    ranges' partials (accumulators, then m and l; None with one range).
    The workspace is freed on return; the caching allocator hands it out
    again only to work queued behind the merge on the stream."""
    B, W, h, hd = q.shape
    kv, nblk = k_pool.shape[2], block_tables.shape[1]
    rows = W * (h // kv)
    groups = col_groups(hd)[2]
    splits = kv_splits(B, kv, rows, nblk, runtime.sm_count(q.device),
                       resident_ctas(q.device, q.dtype, k_pool.dtype, hd,
                                     nblk, kernel), groups)
    ws = torch.empty(splits * B * W * h * (hd + 2), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    return (B * kv * row_tiles(rows) * groups, splits), ws


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for the C interface (None: null)."""
    return None if t is None else t.data_ptr()


def check_operands(name: str, q, k_pool, v_pool, block_tables, lens,
                   k_scale=None, v_scale=None, live_kv=None):
    """Shape / dtype checks shared by both paged attention wrappers (q is
    [B, W, h, hd] here).  ``live_kv`` is None or ``[B]`` int32 on q's
    device with values in [0, kv]; its values are checked where they lie
    on the host (on the card a check would wait for the device, and the
    kernel reads a value past kv as every group live, one below 0 as none)."""
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
    if live_kv is None:
        return
    if live_kv.shape != (B,) or live_kv.dtype != torch.int32 \
            or live_kv.device != q.device:
        raise ValueError(f"{name}: live_kv must be int32 [B={B}] on q's "
                         f"device {q.device}, got {live_kv.dtype} "
                         f"{tuple(live_kv.shape)} on {live_kv.device}")
    if live_kv.device.type == "cpu" and \
            bool(((live_kv < 0) | (live_kv > kv)).any()):
        raise ValueError(f"{name}: live_kv values must lie in [0, kv={kv}], "
                         f"got {live_kv.tolist()}")


def launch_checks(name: str, q, k_pool, v_pool, block_tables, lens,
                  k_scale=None, v_scale=None, scale: float | None = None,
                  live_kv=None) -> float:
    """The checks both paged attention kernels' launches make: every
    operand on one CUDA device and contiguous, q and the pools 16-byte
    aligned (rows are copied as 16-byte vectors).  Returns the softmax
    scale, 1 / sqrt(hd) unless one is given."""
    opt = {k: t for k, t in (("k_scale", k_scale), ("v_scale", v_scale),
                             ("live_kv", live_kv)) if t is not None}
    runtime.require_cuda(name, q, k_pool, v_pool, block_tables, lens,
                         *opt.values())
    runtime.require_contiguous(name, q=q, k_pool=k_pool, v_pool=v_pool,
                               block_tables=block_tables, lens=lens, **opt)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"{name}: q and the pools must be 16-byte aligned "
                         "(rows are copied as 16-byte vectors)")
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("chunked_prefill_attention",
                        [p] * 10 + [i] * 10 + [ctypes.c_float, p])


def chunked_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_tables: torch.Tensor,
                              start: torch.Tensor, *,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None,
                              live_kv: torch.Tensor | None = None,
                              scale: float | None = None) -> torch.Tensor:
    """W-lane chunk/decode attention over the pooled KV cache.

    q:            [B, W, h, hd]     lane l sits at cache position start[b] + l
    k/v_pool:     [NB, bs, kv, hd]  the shared block pool (row 0 = null)
    block_tables: [B, nblk] int32   physical block of each logical block
    start:        [B] int32         first lane's cache position per slot
    k/v_scale:    [NB, bs, kv] f32  with an int8 pool only: per-row scales
    live_kv:      [B] int32 or None live kv groups per slot, in [0, kv], on
                                    q's device: every head of a group
                                    g >= live_kv[b] gives exact zeros
    -> [B, W, h, hd] in q's dtype

    The caller guarantees table entries lie in [0, NB) and that no live
    lane sees a null-block entry.  The launch never waits for the device:
    the grid comes from the shapes, and start, live_kv and the tables stay
    on it.  A call that splits its keys launches the walk and the merge
    kernel.  ``launches`` counts calls, ``live_kv_launches`` those with
    ``live_kv``.
    """
    name = "chunked_prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, W, h, hd]")
    check_operands(name, q, k_pool, v_pool, block_tables, start, k_scale,
                   v_scale, live_kv)
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(
            q, k_pool, v_pool, block_tables, start, scale, k_scale=k_scale,
            v_scale=v_scale, live_kv=live_kv)
    scale = launch_checks(name, q, k_pool, v_pool, block_tables, start,
                          k_scale, v_scale, scale, live_kv)
    B, W, h, hd = q.shape
    check_head_dim(hd, name, q.dtype, k_pool.dtype, block_tables.shape[1])
    _, bs, kv, _ = k_pool.shape
    grid, ws = walk_plan(name, q, k_pool, block_tables)
    out = torch.empty_like(q)
    runtime.launch(
        name, _kernel(), q, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
        block_tables.data_ptr(), start.data_ptr(), ptr(live_kv),
        out.data_ptr(), ptr(ws), B, W, h, kv, hd, bs, block_tables.shape[1],
        grid[1], runtime.DTYPE_CODES[q.dtype],
        runtime.DTYPE_CODES[k_pool.dtype], float(scale))
    chunked_prefill_attention.launches += 1
    chunked_prefill_attention.live_kv_launches += live_kv is not None
    chunked_prefill_attention.last_grid = grid
    return out


chunked_prefill_attention.launches = 0
chunked_prefill_attention.live_kv_launches = 0
# (CTAs of 16 query rows x column groups, key ranges) of the last launch
chunked_prefill_attention.last_grid = None
