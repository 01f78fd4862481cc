"""The RG-LRU recurrence of a prefill as one kernel.

``rglru_scan(a, g, lengths)`` runs ``h_t = a_t * h_{t-1} + g_t`` from
``h_{-1} = 0`` over ``t = 0 .. S-1`` for every row and channel of ``a``,
``g`` ``[B, S, W]`` (float32) and returns ``(hs, h)``: h at every position
``[B, S, W]`` and the last ``[B, W]``.  ``lengths`` ([B] int32, or None for
S each) is each row's count of real positions: from there on h is kept
(the recurrence with ``a = 1``, ``g = 0``, which is exact), so a prompt
right-padded up to its bucket leaves the state of its last real token.

The reference has no Pallas kernel here: its recurrence is a ``lax.scan``
(``src/repro/models/rglru.py``), one device loop.  A CUDA tensor launches
the hand-written kernel of ``csrc/rglru_scan.cu``, one launch in place of
~3 x S operators; a CPU tensor runs ``rglru_scan_plain``, the same loop in
PyTorch, whose two float32 operators a step the kernel repeats bit for
bit.

With grad enabled and ``a`` or ``g`` requiring it, the call goes through
``RGLRUScanFn``, whose backward is ``rglru_scan_bwd``: the recurrence's
adjoint in reverse time over the saved ``a`` and ``hs``, the kernel of
``csrc/rglru_scan.cu`` on a CUDA tensor (there is no fallback: it launches
or raises) and ``rglru_scan_bwd_plain`` on a CPU one.  Training passes no
``lengths``; a call with both ``lengths`` and a gradient is refused.
Otherwise (serving, ``torch.no_grad``) the call is the kernel's launch
alone, as it was.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime


def rglru_scan_plain(a: torch.Tensor, g: torch.Tensor,
                     lengths: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: one multiply and one add a
    position, in float32; a position at or past its row's length keeps
    h."""
    b, s, w = a.shape
    h = torch.zeros(b, w, dtype=torch.float32, device=a.device)
    hs = torch.empty(b, s, w, dtype=torch.float32, device=a.device)
    for t in range(s):
        step = a[:, t] * h + g[:, t]
        h = step if lengths is None else torch.where(
            (t < lengths)[:, None], step, h)
        hs[:, t] = h
    return hs, h


def _check(a: torch.Tensor, g: torch.Tensor,
           lengths: torch.Tensor | None) -> None:
    if a.dim() != 3 or g.shape != a.shape:
        raise ValueError(f"rglru_scan: a and g must be one [B, S, W] shape, "
                         f"got {tuple(a.shape)} and {tuple(g.shape)}")
    if a.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"rglru_scan: a and g must be float32, got "
                         f"{a.dtype} and {g.dtype}")
    if lengths is not None and (lengths.shape != (a.shape[0],)
                                or lengths.dtype != torch.int32):
        raise ValueError(f"rglru_scan: lengths must be [B={a.shape[0]}] "
                         f"int32, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")


def rglru_scan_bwd_plain(a: torch.Tensor, hs: torch.Tensor,
                         dhs: torch.Tensor, dh: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch: ``(da, dg)``
    ``[B, S, W]`` from the gradients of every h (``dhs`` [B, S, W]) and of
    the last (``dh`` [B, W]), in reverse time: gh = dhs_t + carry (carry
    = dh at S - 1, then a_{t+1} * gh_{t+1}), dg_t = gh, da_t = gh *
    h_{t-1} (h_{-1} = 0); one float32 operator each."""
    s = a.shape[1]
    da, dg = torch.empty_like(a), torch.empty_like(a)
    carry = dh
    for t in reversed(range(s)):
        gh = dhs[:, t] + carry
        dg[:, t] = gh
        da[:, t] = gh * (hs[:, t - 1] if t else torch.zeros_like(gh))
        carry = a[:, t] * gh
    return da, dg


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("rglru_scan", [p, p, p, p, p, i, i, i, p])


@functools.cache
def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("rglru_scan_bwd", [p, p, p, p, p, p, i, i, i, p])


class RGLRUScanFn(torch.autograd.Function):
    """``rglru_scan`` with its backward: saves ``a`` and ``hs``."""

    @staticmethod
    def forward(ctx, a, g):
        hs, h = _forward(a, g, None)
        ctx.save_for_backward(a, hs)
        return hs, h

    @staticmethod
    def backward(ctx, dhs, dh):
        a, hs = ctx.saved_tensors
        return rglru_scan_bwd(a, hs, dhs.contiguous(), dh.contiguous())


def rglru_scan(a: torch.Tensor, g: torch.Tensor,
               lengths: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hs [B, S, W], h [B, W])`` of the recurrence over ``a``, ``g``
    ``[B, S, W]`` float32, each row's positions from ``lengths`` on
    keeping h; differentiable in ``a`` and ``g`` (``RGLRUScanFn``) where
    grad is on and either requires it."""
    _check(a, g, lengths)
    if torch.is_grad_enabled() and (a.requires_grad or g.requires_grad):
        if lengths is not None:
            raise ValueError("rglru_scan: lengths with a gradient: training "
                             "scans every position (the reference's "
                             "rglru_forward takes no lengths)")
        return RGLRUScanFn.apply(a, g)
    return _forward(a, g, lengths)


def _forward(a: torch.Tensor, g: torch.Tensor,
             lengths: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    extra = () if lengths is None else (lengths,)
    if all(t.device.type == "cpu" for t in (a, g, *extra)):
        return rglru_scan_plain(a, g, lengths)
    runtime.require_cuda("rglru_scan", a, g, *extra)
    runtime.require_contiguous("rglru_scan", a=a, g=g, **(
        {} if lengths is None else {"lengths": lengths}))
    B, S, W = a.shape
    hs = torch.empty_like(a)
    h = torch.empty(B, W, dtype=torch.float32, device=a.device)
    if a.numel() == 0:
        return hs, h.zero_()
    runtime.launch("rglru_scan", _kernel(), a, a.data_ptr(), g.data_ptr(),
                   None if lengths is None else lengths.data_ptr(),
                   hs.data_ptr(), h.data_ptr(), B, S, W)
    rglru_scan.launches += 1
    return hs, h


rglru_scan.launches = 0


def rglru_scan_bwd(a: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor,
                   dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(da, dg)`` ``[B, S, W]`` of the recurrence (the saved ``a`` and
    ``hs``, the gradients ``dhs`` [B, S, W] and ``dh`` [B, W], float32):
    the kernel on CUDA tensors, ``rglru_scan_bwd_plain`` on CPU ones."""
    if a.dim() != 3 or not a.shape == hs.shape == dhs.shape \
            or dh.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan_bwd: a, hs, dhs must be one [B, S, W] "
                         f"shape and dh [B, W], got {tuple(a.shape)}, "
                         f"{tuple(hs.shape)}, {tuple(dhs.shape)}, "
                         f"{tuple(dh.shape)}")
    if any(t.dtype != torch.float32 for t in (a, hs, dhs, dh)):
        raise ValueError("rglru_scan_bwd: a, hs, dhs and dh must be float32")
    if all(t.device.type == "cpu" for t in (a, hs, dhs, dh)):
        return rglru_scan_bwd_plain(a, hs, dhs, dh)
    runtime.require_cuda("rglru_scan_bwd", a, hs, dhs, dh)
    runtime.require_contiguous("rglru_scan_bwd", a=a, hs=hs, dhs=dhs, dh=dh)
    B, S, W = a.shape
    da, dg = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, dg
    runtime.launch("rglru_scan_bwd", _bwd_kernel(), a, a.data_ptr(),
                   hs.data_ptr(), dhs.data_ptr(), dh.data_ptr(),
                   da.data_ptr(), dg.data_ptr(), B, S, W)
    rglru_scan_bwd.launches += 1
    return da, dg


rglru_scan_bwd.launches = 0
