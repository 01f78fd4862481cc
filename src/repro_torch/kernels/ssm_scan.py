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

With grad enabled and any float operand requiring it, the call goes
through ``SSMScanFn``, whose backward is ``ssm_scan_bwd`` (``ddt, dx, db,
dc, da`` from ``dy`` and the last h's ``dh``): the kernel of
``csrc/ssm_scan.cu`` on CUDA tensors (it launches or raises; there is no
fallback) and ``ssm_scan_bwd_plain`` on CPU ones.  Neither stores h at
every position: both re-run the forward, keep h at the start of every
``CHUNK`` positions, and recompute a chunk's h from it as they walk it in
reverse.  The plain version sums in the kernel's orders (a channel's
states as the readout does; the channels of ``db`` and ``dc`` as the
kernel's warps, CTAs and reduce do, ``_channel_sum``; ``da`` over
positions in reverse, then over rows), so the two agree bit for bit.
Training passes no ``lengths``; a call with both ``lengths`` and a
gradient is refused.  Otherwise (serving, ``torch.no_grad``) the call is
the kernel's launch alone, as it was.
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
# the backward's checkpoint stride (``kChunk`` in csrc/ssm_scan.cu) and a
# CTA's threads and warps, which fix its channel sums' order
CHUNK = 16
CTA_THREADS, CTA_WARPS = 128, 4


def readout(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum_n h[..., n] * c[..., n]`` over the last axis in the scan's
    order: each run of ``GROUP`` states summed in order, then the runs'
    partials pairwise, neighbours first."""
    return _state_sum(h * c)


def _state_sum(prod: torch.Tensor) -> torch.Tensor:
    """The readout's sum over the last axis (the states)."""
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


def _channel_sum(v: torch.Tensor) -> torch.Tensor:
    """``v`` [B, Di, N] summed over the channels in the backward kernel's
    order: a warp's channels pairwise, neighbours first (its butterfly),
    then the CTA's warps in order, then the CTAs in order (the reduce
    kernel); channels past Di are zeros, as the kernel's idle threads
    give."""
    bsz, di, n = v.shape
    per_cta = CTA_THREADS // (n // GROUP)
    ctas = -(-di // per_cta)
    v = torch.nn.functional.pad(v, (0, 0, 0, ctas * per_cta - di))
    v = v.reshape(bsz, ctas, CTA_WARPS, per_cta // CTA_WARPS, n)
    while v.shape[3] > 1:
        v = v[:, :, :, 0::2] + v[:, :, :, 1::2]
    v = v[:, :, :, 0]
    warps = v[:, :, 0]
    for w in range(1, CTA_WARPS):
        warps = warps + v[:, :, w]
    out = warps[:, 0]
    for k in range(1, ctas):
        out = out + warps[:, k]
    return out


def ssm_scan_bwd_plain(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                       dh: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch: ``(ddt, dx, db,
    dc, da)`` of the scan from ``dy`` [B, S, Di] and ``dh`` [B, Di, N],
    float32 (``dx`` in x's dtype).  It keeps h at the start of every
    ``CHUNK`` positions only, recomputes a chunk's h from there, and runs
    the chunk's positions downward with the kernel's float32 operators
    and orders of sums."""
    bsz, s, di = dt.shape
    xf = x.float()

    def advance(h, t):
        d = dt[:, t, :, None]
        a_bar = torch.exp(d * a)
        return a_bar * h + (d * b[:, t, None, :]) * xf[:, t, :, None]

    starts, h = [], torch.zeros_like(dh)
    for t in range(s):
        if t % CHUNK == 0:
            starts.append(h)
        h = advance(h, t)
    ddt = torch.empty_like(dt)
    dx = torch.empty(bsz, s, di, dtype=torch.float32, device=dt.device)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    carry, da = dh, torch.zeros_like(dh)
    for k in reversed(range(len(starts))):
        t0 = k * CHUNK
        hist = [starts[k]]
        for t in range(t0, min(t0 + CHUNK, s)):
            hist.append(advance(hist[-1], t))
        for t in reversed(range(t0, min(t0 + CHUNK, s))):
            h_t, hp = hist[t - t0 + 1], hist[t - t0]
            d = dt[:, t, :, None]
            a_bar = torch.exp(d * a)
            xv, dyv = xf[:, t, :, None], dy[:, t, :, None]
            bv, cv = b[:, t, None, :], c[:, t, None, :]
            gh = dyv * cv + carry
            carry = a_bar * gh
            u = gh * d
            dx[:, t] = _state_sum(u * bv)
            ddt[:, t] = _state_sum(gh * ((a * a_bar) * hp + bv * xv))
            da = da + (u * a_bar) * hp
            db[:, t] = _channel_sum(u * xv)
            dc[:, t] = _channel_sum(h_t * dyv)
    da_sum = da[0]
    for r in range(1, bsz):
        da_sum = da_sum + da[r]
    return ddt, dx.to(x.dtype), db, dc, da_sum


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


@functools.cache
def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("ssm_scan_bwd", [p] * 15 + [i] * 5 + [p])


class SSMScanFn(torch.autograd.Function):
    """``ssm_scan`` with its backward: saves its five operands (h is
    recomputed, never stored)."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a):
        y, h = _forward(dt, x, b, c, a, None)
        ctx.save_for_backward(dt, x, b, c, a)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        return ssm_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                            dh.contiguous())


def ssm_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor,
             lengths: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, Di], h [B, Di, N])`` of the selective scan, float32,
    each row's positions from ``lengths`` on keeping h; differentiable
    (``SSMScanFn``) where grad is on and an operand requires it."""
    _check(dt, x, b, c, a, lengths)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, b, c, a)):
        if lengths is not None:
            raise ValueError("ssm_scan: lengths with a gradient: training "
                             "scans every position (the reference's "
                             "ssm_forward takes no lengths)")
        return SSMScanFn.apply(dt, x, b, c, a)
    return _forward(dt, x, b, c, a, lengths)


def _forward(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor,
             lengths: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
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


def ssm_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                 dh: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(ddt, dx, db, dc, da)`` of the selective scan from ``dy`` [B, S,
    Di] and ``dh`` [B, Di, N] (float32; ``dx`` in x's dtype): the kernel
    and its ordered reduce on CUDA tensors, ``ssm_scan_bwd_plain`` on CPU
    ones."""
    _check(dt, x, b, c, a, None)
    bsz, s, di = dt.shape
    n = a.shape[1]
    if dy.shape != dt.shape or dh.shape != (bsz, di, n) \
            or dy.dtype != torch.float32 or dh.dtype != torch.float32:
        raise ValueError(f"ssm_scan_bwd: dy must be [{bsz}, {s}, {di}] and "
                         f"dh [{bsz}, {di}, {n}], float32; got "
                         f"{tuple(dy.shape)} {dy.dtype}, {tuple(dh.shape)} "
                         f"{dh.dtype}")
    ops = (dt, x, b, c, a, dy, dh)
    if all(t.device.type == "cpu" for t in ops):
        return ssm_scan_bwd_plain(*ops)
    runtime.require_cuda("ssm_scan_bwd", *ops)
    runtime.require_contiguous("ssm_scan_bwd", dt=dt, x=x, b=b, c=c, a=a,
                               dy=dy, dh=dh)
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty(di, n, **f32)
    if dt.numel() == 0:
        return ddt, dx, db, dc, da.zero_()
    ctas = -(-di // (CTA_THREADS // (n // GROUP)))
    ckpt = torch.empty(bsz, -(-s // CHUNK), di, n, **f32)
    part_bc = torch.empty(bsz, s, ctas, 2 * n, **f32)
    part_a = torch.empty(bsz, di, n, **f32)
    runtime.launch("ssm_scan_bwd", _bwd_kernel(), dt,
                   *(t.data_ptr() for t in (
                       dt, x, b, c, a, dy, dh, ckpt, part_bc, part_a, ddt, dx,
                       db, dc, da)),
                   runtime.DTYPE_CODES[x.dtype], bsz, s, di, n)
    ssm_scan_bwd.launches += 1
    return ddt, dx, db, dc, da


ssm_scan_bwd.launches = 0
