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


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("rglru_scan", [p, p, p, p, p, i, i, i, p])


def rglru_scan(a: torch.Tensor, g: torch.Tensor,
               lengths: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hs [B, S, W], h [B, W])`` of the recurrence over ``a``, ``g``
    ``[B, S, W]`` float32, each row's positions from ``lengths`` on
    keeping h."""
    _check(a, g, lengths)
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
