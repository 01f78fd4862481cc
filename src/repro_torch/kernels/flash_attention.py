"""Flash attention over contiguous sequences: the counterpart of the
reference's Pallas ``flash_attention``.

``flash_attention(q, k, v, causal=True)`` takes ``q [B, Sq, H, hd]`` and
``k / v [B, Skv, H, hd]`` (kv heads already repeated to H), in one dtype
(float32 or bfloat16), and returns ``[B, Sq, H, hd]`` in q's dtype:
softmax(q k^T / sqrt(hd)) v with an online softmax in float32, keys past
Skv masked and, with ``causal``, key j seen by query i only when
``j <= i`` (top-left aligned; Sq != Skv allowed).  The reference kernel
takes ``[B*H, S, hd]`` and its ``ops`` wrapper transposes to it; this
wrapper and its kernel take the ``ops`` layout directly, so nothing is
transposed in device memory (``[B*H, S, hd]`` is the case H = 1).  A CUDA
tensor launches the hand-written kernel of ``csrc/flash_attention.cu``; a
CPU tensor runs the plain version.

The kernel gives each CTA 64 query rows of one (b, h) and one group of at
most 128 output columns (``col_groups``: one group up to hd 128, else
ceil(hd / 128)); every group sums the same scores over the whole hd, so
their running (max, sum) agree bit for bit.  The grid (``grid``) is (B x
H x column groups x chunks, query tiles, key ranges), at most 65535 query
tiles on y and the rest in chunks of 65535 on x, and ``cta_block`` gives
the part of the output each CTA writes.  Where the CTAs leave the card's SMs idle,
``kv_splits`` cuts the keys into ranges of whole 64-key tiles
(``kv_ranges``); each range's CTAs write an unnormalised float32
accumulator and the running (max, sum) to a workspace, and a merge kernel
combines them.  ``flash_attention_partial_plain`` (whose range [0, Skv)
over all columns is ``flash_attention_plain``) and
``merge_partials_plain`` are those two steps in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 64                   # the kernel's query rows per CTA and keys per tile
GROUP = 128                 # output columns per CTA where hd > 128
MAX_X = 2 ** 31 - 1         # grid x: B x H x column groups x tile chunks
MAX_Y = 65535               # grid y: query tiles per chunk


def _block(skv: int) -> int:
    """The reference's kv block: min(512, Skv rounded up to 8)."""
    return min(512, -(-skv // 8) * 8)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the Pallas kernel's
    order: ``flash_attention_partial_plain`` over all keys, then O = acc /
    max(l, 1e-30)."""
    acc, _, l = flash_attention_partial_plain(q, k, v, 0, k.shape[1],
                                              causal=causal)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype).contiguous()


def _kv_len(sq: int, skv: int, causal: bool) -> int:
    """The keys any query sees (top-left causal: none past Sq - 1)."""
    return min(skv, sq) if causal else skv


def col_groups(hd: int) -> list[tuple[int, int]]:
    """The output columns [lo, hi) of each CTA's column group (grid y):
    all of hd up to 128, else groups of 128 with a ragged last one."""
    if hd <= GROUP:
        return [(0, hd)]
    return [(c, min(hd, c + GROUP)) for c in range(0, hd, GROUP)]


def grid(B: int, H: int, Sq: int, hd: int,
         max_y: int = MAX_Y) -> tuple[int, int]:
    """The kernel's grid (x, y) before the key ranges (z): x = B x H x
    column groups x ceil(query tiles / ``max_y``), y = the query tiles of
    one chunk."""
    qtiles, groups = -(-Sq // TILE), len(col_groups(hd))
    return B * H * groups * -(-qtiles // max_y), min(qtiles, max_y)


def cta_block(B: int, H: int, Sq: int, hd: int, causal: bool, x: int,
              y: int, max_y: int = MAX_Y
              ) -> tuple[int, int, int, int, int, int] | None:
    """The output block (b, h, first row, row end, first column, column
    end) that the CTA at grid (x, y) writes, as the kernel's ``tile_of``
    computes it (None: a CTA past the last query tile).  x runs over the
    (b, h) pairs fastest, then the column groups, then the chunks of
    ``max_y`` query tiles; y over a chunk's tiles, the last tile first
    where ``causal``."""
    qtiles, groups = -(-Sq // TILE), col_groups(hd)
    pair, rest = x % (B * H), x // (B * H)
    qi = rest // len(groups) * max_y + y
    if qi >= qtiles:
        return None
    qt = qtiles - 1 - qi if causal else qi
    lo, hi = groups[rest % len(groups)]
    return (pair // H, pair % H, qt * TILE, min(Sq, (qt + 1) * TILE), lo, hi)


def kv_splits(B: int, H: int, Sq: int, Skv: int, causal: bool,
              sms: int, groups: int = 1) -> int:
    """How many key ranges the kernel's grid takes: 1 where the
    ceil(Sq/64) * B * H * ``groups`` CTAs already cover the ``sms`` SMs;
    else about one wave of CTAs (``sms // ctas`` ranges), capped so that
    every range holds at least two 64-key tiles."""
    ctas = -(-Sq // TILE) * B * H * groups
    if ctas >= sms:
        return 1
    tiles = -(-_kv_len(Sq, Skv, causal) // TILE)
    return max(1, min(sms // ctas, tiles // 2))


def kv_ranges(Sq: int, Skv: int, causal: bool,
              splits: int) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) of a split: whole 64-key tiles, as even as
    the tile count allows, covering the keys any query sees.  The kernel
    computes the same ranges from its grid index."""
    kv = _kv_len(Sq, Skv, causal)
    tiles = -(-kv // TILE)
    return [(s * tiles // splits * TILE,
             min(kv, (s + 1) * tiles // splits * TILE))
            for s in range(splits)]


def flash_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, lo: int, hi: int, *,
                                  causal: bool = True,
                                  cols: tuple[int, int] | None = None
                                  ) -> tuple[torch.Tensor, ...]:
    """The Pallas kernel's block loop over the keys [lo, hi): the running
    (max, sum, f32 accumulator) is updated once per kv block of the
    reference's size, masked scores are ``NEG_INF``, and p is rounded to
    V's dtype before the PV product.  Returns the unnormalised float32
    accumulator ``[B, Sq, H, hd]`` (``cols`` = (c0, c1): only V's columns
    [c0, c1), a column group's share, ``[B, Sq, H, c1 - c0]``; the scores
    still sum over the whole hd) and the running max and sum ``[B, Sq,
    H]``.  A row that sees no key of the range keeps m = NEG_INF and l = 0
    (p of a masked score is 0)."""
    B, Sq, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    c0, c1 = (0, hd) if cols is None else cols
    qf = q.transpose(1, 2).float()                       # [B, H, Sq, hd]
    kf = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)[..., c0:c1]
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, c1 - c0), device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    bkv = _block(hi - lo)
    for k0 in range(lo, hi, bkv):
        kb, vb = kf[:, :, k0:min(k0 + bkv, hi)], vt[:, :, k0:min(k0 + bkv, hi)]
        s = (qf @ kb.transpose(-1, -2)) * scale
        seen = torch.ones_like(s, dtype=torch.bool)
        if causal:
            kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            seen = (kpos <= qpos).expand_as(s)
            s = torch.where(seen, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
    return (acc.transpose(1, 2), m[..., 0].transpose(1, 2),
            l[..., 0].transpose(1, 2))


def merge_partials_plain(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel in plain PyTorch: acc ``[splits, B, Sq, H, hd]``, m
    and l ``[splits, B, Sq, H]`` -> O ``[B, Sq, H, hd]`` in ``out_dtype``,
    with m* = max m_s, O = sum acc_s e^(m_s - m*) / max(sum l_s e^(m_s -
    m*), 1e-30).  A range with m_s = NEG_INF weighs 0 and its accumulator
    is not read (the chunked-prefill kernel never writes it)."""
    live = m > NEG_INF
    w = torch.where(live, torch.exp(m - m.amax(0, keepdim=True)), 0.0)
    acc = torch.where(live[..., None], acc, 0.0)
    lsum = (l * w).sum(0)
    out = (acc * w[..., None]).sum(0) / lsum.clamp_min(1e-30)[..., None]
    return out.to(out_dtype)


def check_grid(B: int, H: int, Sq: int, hd: int) -> None:
    """What the hardware's grid holds: at most 2^31 - 1 CTAs on x (B x H
    x column groups x chunks of 65535 query tiles).  Any other hd and Sq
    are taken."""
    x = grid(B, H, Sq, hd)[0]
    if x > MAX_X:
        raise ValueError(
            f"flash_attention: the kernel takes what the hardware's grid "
            f"holds, at most 2^31 - 1 CTAs on x (B x H x ceil(hd / 128) "
            f"column groups x ceil(ceil(Sq / 64) / 65535) tile chunks); got "
            f"{x} (B = {B}, H = {H}, Sq = {Sq}, hd = {hd})")


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("flash_attention",
                        [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p,
                         i, p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, hd], k / v [B, Skv, H, hd] -> [B, Sq, H, hd]."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (k.shape[0], k.shape[2], k.shape[3]) != \
            (q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; need "
                         "[B, Sq, H, hd] and two [B, Skv, H, hd]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; all must be one of {_DTYPES}")
    B, Sq, H, hd = q.shape
    skv = k.shape[1]
    if skv == 0 or hd == 0:
        raise ValueError("flash_attention: needs Skv > 0 and hd > 0")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal)
    runtime.require_cuda("flash_attention", q, k, v)
    runtime.require_contiguous("flash_attention", q=q, k=k, v=v)
    check_grid(B, H, Sq, hd)
    o = torch.empty_like(q)
    if B == 0 or Sq == 0 or H == 0:
        return o
    ctas = -(-Sq // TILE) * B * H
    groups = len(col_groups(hd))
    splits = kv_splits(B, H, Sq, skv, causal, runtime.sm_count(q.device),
                       groups)
    # splits > 1: the ranges' accumulators, then their m and l, in float32
    ws = torch.empty(splits * B * Sq * H * (hd + 2), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    runtime.launch("flash_attention", _kernel(), q, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Sq, skv,
                   hd, 1.0 / math.sqrt(hd), int(causal),
                   runtime.DTYPE_CODES[q.dtype],
                   None if ws is None else ws.data_ptr(), splits)
    flash_attention.launches += 1
    flash_attention.last_grid = (ctas, groups, splits)
    return o


flash_attention.launches = 0
# (query-tile CTAs, column groups, key ranges) of the last launch
flash_attention.last_grid = None
