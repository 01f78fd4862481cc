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
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime

_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 128          # the kernel keeps hd / 32 features per lane


def _block(skv: int) -> int:
    """The reference's kv block: min(512, Skv rounded up to 8)."""
    return min(512, -(-skv // 8) * 8)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the Pallas kernel's
    order: the running (max, sum, f32 accumulator) is updated once per kv
    block of the reference's size, masked scores are ``NEG_INF``, p is
    rounded to V's dtype before the PV product, and O = acc / max(l,
    1e-30)."""
    B, Sq, H, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.transpose(1, 2).float()                       # [B, H, Sq, hd]
    kf = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    m = torch.full((B, H, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, hd), device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    bkv = _block(skv)
    for k0 in range(0, skv, bkv):
        kb, vb = kf[:, :, k0:k0 + bkv], vt[:, :, k0:k0 + bkv]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
    out = acc / l.clamp_min(1e-30)
    return out.to(q.dtype).transpose(1, 2).contiguous()


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("flash_attention",
                        [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p])


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
    if hd > MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"flash_attention: the kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and B * H <= 65535, got hd={hd}, "
                         f"B * H = {B * H}")
    o = torch.empty_like(q)
    if B == 0 or Sq == 0 or H == 0:
        return o
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, H, Sq, skv, hd, 1.0 / math.sqrt(hd), int(causal),
                    runtime.DTYPE_CODES[q.dtype], runtime.stream_handle(q))
    runtime.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
