"""The selective scan of a Mamba-1 prefill as one kernel.

``ssm_scan(dt, x, b, c, a, lengths)`` runs the ssm family's recurrence
over ``t = 0 .. S-1`` for every row, channel and state, from ``h = 0``:

    a_bar = exp(dt_t * a)            [Di, N]
    bx    = (dt_t * b_t) * x_t       [Di, N]
    h     = a_bar * h + bx
    y_t   = sum_n h[n] * c_t[n]      (the order of ``readout``)

with ``dt`` ``[B, S, Di]`` float32 (after softplus), ``x`` ``[B, S, Di]``
(the conv output in the compute dtype, read as float32), ``b`` and ``c``
``[B, S, N]`` float32, ``a`` ``[Di, N]`` float32 (``-exp(a_log)``), and
returns ``(y [B, S, Di], h [B, Di, N])``, both float32.  ``lengths`` ([B]
int32, or None for S each) is each row's count of real positions: from
there on h is kept and ``y_t`` reads the kept h, so a prompt right-padded
up to its bucket leaves the state of its last real token.

The reference has no Pallas kernel here: its recurrence is a ``lax.scan``
(``src/repro/models/ssm.py``) over ``a_bar`` and ``bx`` that it first
materializes at ``[B, S, Di, N]`` in float32.  A CUDA tensor launches the
hand-written kernel of ``csrc/ssm_scan.cu``, which discretizes in
registers and writes neither; a CPU tensor runs ``ssm_scan_plain``, the
same loop in PyTorch, whose float32 operators a step (and the readout's
order of sums) the kernel repeats bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

# the readout sums each run of GROUP consecutive states in order, then the
# runs' partials pairwise, neighbours first (the kernel: a thread's states,
# then a butterfly of shuffles over the N / GROUP threads of a channel)
GROUP = 4


def readout(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum_n h[..., n] * c[..., n]`` over the last axis in the scan's
    order: each run of ``GROUP`` states summed in order, then the runs'
    partials pairwise, neighbours first."""
    prod = h * c
    prod = prod.reshape(*prod.shape[:-1], -1, GROUP)
    part = prod[..., 0]
    for g in range(1, GROUP):
        part = part + prod[..., g]
    while part.shape[-1] > 1:
        part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0]


def ssm_scan_plain(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor,
                   lengths: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: per position the
    discretization, one multiply and one add into h and the readout, in
    float32; a position at or past its row's length keeps h."""
    bsz, s, di = dt.shape
    h = torch.zeros(bsz, di, a.shape[1], dtype=torch.float32,
                    device=dt.device)
    y = torch.empty(bsz, s, di, dtype=torch.float32, device=dt.device)
    for t in range(s):
        d = dt[:, t, :, None]
        a_bar = torch.exp(d * a)
        bx = (d * b[:, t, None, :]) * x[:, t, :, None].float()
        step = a_bar * h + bx
        h = step if lengths is None else torch.where(
            (t < lengths)[:, None, None], step, h)
        y[:, t] = readout(h, c[:, t, None, :])
    return y, h


def _check(dt, x, b, c, a, lengths) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"ssm_scan: dt and x must be one [B, S, Di] shape, "
                         f"got {tuple(dt.shape)} and {tuple(x.shape)}")
    bsz, s, di = dt.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"ssm_scan: a must be [Di={di}, N], got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    for name, t in (("b", b), ("c", c)):
        if t.shape != (bsz, s, n):
            raise ValueError(f"ssm_scan: {name} must be [{bsz}, {s}, {n}], "
                             f"got {tuple(t.shape)}")
    if any(t.dtype != torch.float32 for t in (dt, b, c, a)):
        raise ValueError("ssm_scan: dt, b, c and a must be float32")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssm_scan: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if lengths is not None and (lengths.shape != (bsz,)
                                or lengths.dtype != torch.int32):
        raise ValueError(f"ssm_scan: lengths must be [B={bsz}] int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    # a channel's N / GROUP threads share a warp: a power of two up to 32
    runs = n // GROUP
    if n % GROUP or runs < 1 or runs > 32 or runs & (runs - 1):
        raise ValueError(f"ssm_scan: state size N={n} must be {GROUP} x a "
                         "power of two up to 32 (4, 8, 16, ..., 128)")


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("ssm_scan",
                        [p, p, p, p, p, p, p, p, i, i, i, i, i, p])


def ssm_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor,
             lengths: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, Di], h [B, Di, N])`` of the selective scan, float32,
    each row's positions from ``lengths`` on keeping h."""
    _check(dt, x, b, c, a, lengths)
    extra = () if lengths is None else (lengths,)
    if all(t.device.type == "cpu" for t in (dt, x, b, c, a, *extra)):
        return ssm_scan_plain(dt, x, b, c, a, lengths)
    runtime.require_cuda("ssm_scan", dt, x, b, c, a, *extra)
    runtime.require_contiguous("ssm_scan", dt=dt, x=x, b=b, c=c, a=a, **(
        {} if lengths is None else {"lengths": lengths}))
    bsz, s, di = dt.shape
    n = a.shape[1]
    y = torch.empty(bsz, s, di, dtype=torch.float32, device=dt.device)
    h = torch.empty(bsz, di, n, dtype=torch.float32, device=dt.device)
    if dt.numel() == 0:
        return y, h.zero_()
    runtime.launch("ssm_scan", _kernel(), dt, dt.data_ptr(), x.data_ptr(),
                   b.data_ptr(), c.data_ptr(), a.data_ptr(),
                   None if lengths is None else lengths.data_ptr(),
                   y.data_ptr(), h.data_ptr(), runtime.DTYPE_CODES[x.dtype],
                   bsz, s, di, n)
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0
