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
order of sums: one pairwise tree over the N states, neighbours first) the
kernel repeats bit for bit, whatever number of states a thread holds
(``states_per_thread``).

With grad enabled and any float operand requiring it, the call goes
through ``SSMScanFn``, whose backward is ``ssm_scan_bwd`` (``ddt, dx, db,
dc, da`` from ``dy`` and the last h's ``dh``): the kernel of
``csrc/ssm_scan.cu`` on CUDA tensors (it launches or raises; there is no
fallback) and ``ssm_scan_bwd_plain`` on CPU ones.  Neither stores h at
every position: the forward keeps h at the start of every ``CHUNK``
positions (the checkpoints, ``[B, ceil(S / CHUNK), Di, N]`` float32, saved
for the backward), and the backward recomputes a chunk's h from its
checkpoint as it walks the chunk in reverse (a backward called without
them launches the forward kernel for them first).  The plain version sums
in the kernel's orders (a channel's states as the readout does; the
channels of ``db`` and ``dc`` by a pairwise tree over a CTA's channels,
then over the CTAs in order, ``_channel_sum``; ``da`` over positions in
reverse, then over rows), so the two agree bit for bit.
Training passes no ``lengths``; a call with both ``lengths`` and a
gradient is refused.  Otherwise (serving, ``torch.no_grad``) the call is
the kernel's launch alone, as it was.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

# the backward's checkpoint stride (``kChunk`` in csrc/ssm_scan.cu) and a
# CTA's threads (``kThreads``), which with the states a thread holds fix a
# CTA's channels and so the order of the backward's channel sums
CHUNK = 16
CTA_THREADS = 256
# the states a thread holds that the kernels are built for at each N
# (``REPRO_SSM_*_PAIRS`` in csrc/ssm_scan.cu)
BUILT = {"forward": {4: (1,), 8: (2,), 16: (2, 4), 32: (2,), 64: (4,),
                     128: (8,)},
         "backward": {4: (1,), 8: (1,), 16: (2,), 32: (1,), 64: (2,),
                      128: (4,)}}


def states_per_thread(n: int, backward: bool = False,
                      row_channels: int = 0) -> int:
    """G, the consecutive states of a channel one thread holds at state
    size ``n`` (N / G threads a channel, ``CTA_THREADS`` a CTA) in a call
    over ``row_channels`` (rows x channels).  Any G gives the forward's
    bits; the backward's G fixes its CTAs' channels (``_channel_sum``) and
    needs N / G <= 32; the forward spills registers past 16 threads a
    channel.  At N 16 the choice is the measured one
    (``launch/scan_probe.py --sweep``, PERF.md): the forward at 4 where
    that grid still holds 256 CTAs (64 channels each; about two an SM:
    fewer loads a state), else at 2 (a prefill's one row, a narrow Di:
    more warps), the backward at 2."""
    if n == 16:
        return 4 if not backward and row_channels >= 256 * 64 else 2
    if backward:
        return max(1, n // 32)
    return 1 if n == 4 else max(2, n // 16)


def cta_channels(n: int) -> int:
    """The backward kernel's channels a CTA at state size ``n``."""
    return CTA_THREADS // (n // states_per_thread(n, backward=True))


def readout(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum_n h[..., n] * c[..., n]`` over the last axis in the scan's
    order: one pairwise tree over the states, neighbours first."""
    return _state_sum(h * c)


def _state_sum(prod: torch.Tensor) -> torch.Tensor:
    """The readout's sum over the last axis (the states, a power of two):
    neighbours first, then the pairs' sums pairwise, and so on."""
    while prod.shape[-1] > 1:
        prod = prod[..., 0::2] + prod[..., 1::2]
    return prod[..., 0]


def ssm_scan_plain(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor,
                   lengths: torch.Tensor | None = None,
                   checkpoints: bool = False) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: per position the
    discretization, one multiply and one add into h and the readout, in
    float32; a position at or past its row's length keeps h.  With
    ``checkpoints``, also the loop's h at the start of every ``CHUNK``
    positions, ``[B, ceil(S / CHUNK), Di, N]``."""
    bsz, s, di = dt.shape
    h = torch.zeros(bsz, di, a.shape[1], dtype=torch.float32,
                    device=dt.device)
    y = torch.empty(bsz, s, di, dtype=torch.float32, device=dt.device)
    starts = []
    for t in range(s):
        if t % CHUNK == 0:
            starts.append(h)
        d = dt[:, t, :, None]
        a_bar = torch.exp(d * a)
        bx = (d * b[:, t, None, :]) * x[:, t, :, None].float()
        step = a_bar * h + bx
        h = step if lengths is None else torch.where(
            (t < lengths)[:, None, None], step, h)
        y[:, t] = readout(h, c[:, t, None, :])
    if not checkpoints:
        return y, h
    ckpt = torch.stack(starts, 1) if starts else h.new_zeros(
        bsz, 0, di, a.shape[1])
    return y, h, ckpt


def _channel_sum(v: torch.Tensor) -> torch.Tensor:
    """``v`` [B, Di, N] summed over the channels in the backward kernel's
    order: a CTA's ``cta_channels(N)`` channels by a pairwise tree,
    neighbours first, then the CTAs in order (the reduce kernel); channels
    past Di are zeros, as the kernel's idle threads give."""
    bsz, di, n = v.shape
    per_cta = cta_channels(n)
    ctas = -(-di // per_cta)
    v = torch.nn.functional.pad(v, (0, 0, 0, ctas * per_cta - di))
    v = v.reshape(bsz, ctas, per_cta, n)
    while v.shape[2] > 1:
        v = v[:, :, 0::2] + v[:, :, 1::2]
    v = v[:, :, 0]
    out = v[:, 0]
    for k in range(1, ctas):
        out = out + v[:, k]
    return out


def ssm_scan_bwd_plain(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                       dh: torch.Tensor, ckpt: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch: ``(ddt, dx, db,
    dc, da)`` of the scan from ``dy`` [B, S, Di] and ``dh`` [B, Di, N],
    float32 (``dx`` in x's dtype).  It starts each chunk of ``CHUNK``
    positions from its checkpoint (``ckpt``, the forward's, or, without
    it, h kept while re-running the forward), recomputes the chunk's h,
    and runs the chunk's positions downward with the kernel's float32
    operators and orders of sums."""
    bsz, s, di = dt.shape
    xf = x.float()

    def advance(h, t):
        d = dt[:, t, :, None]
        a_bar = torch.exp(d * a)
        return a_bar * h + (d * b[:, t, None, :]) * xf[:, t, :, None]

    if ckpt is not None:
        starts = list(ckpt.unbind(1))
    else:
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
    if n not in BUILT["forward"]:
        raise ValueError(f"ssm_scan: state size N={n} must be 4 x a power "
                         "of two up to 32 (4, 8, 16, ..., 128)")


def _plan(n: int, backward: bool, row_channels: int = 0) -> int:
    g = states_per_thread(n, backward, row_channels)
    if g not in BUILT["backward" if backward else "forward"][n]:
        raise ValueError(f"ssm_scan: no kernel built for N={n} at {g} "
                         "states a thread")
    return g


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("ssm_scan", [p] * 9 + [i] * 6 + [p])


@functools.cache
def smem_bytes():
    """``smem_bytes()(N, G, backward)``: the dynamic shared memory of the
    kernel built for (N, G), in bytes (0 where none is built)."""
    i = ctypes.c_int
    return runtime.bind("ssm_scan_smem_bytes", [i, i, i])


@functools.cache
def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return runtime.bind("ssm_scan_bwd", [p] * 15 + [i] * 6 + [p])


class SSMScanFn(torch.autograd.Function):
    """``ssm_scan`` with its backward: saves its five operands and the
    forward's checkpoints (h every ``CHUNK`` positions; h itself is
    recomputed, never stored)."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a):
        y, h, ckpt = _forward(dt, x, b, c, a, None, checkpoints=True)
        ctx.save_for_backward(dt, x, b, c, a, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        *ops, ckpt = ctx.saved_tensors
        return ssm_scan_bwd(*ops, dy.contiguous(), dh.contiguous(), ckpt)


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
             lengths: torch.Tensor | None, checkpoints: bool = False
             ) -> tuple[torch.Tensor, ...]:
    """``(y, h)``, and with ``checkpoints`` the checkpoints too: the
    kernel's one launch on CUDA tensors, the plain loop on CPU ones."""
    extra = () if lengths is None else (lengths,)
    if all(t.device.type == "cpu" for t in (dt, x, b, c, a, *extra)):
        return ssm_scan_plain(dt, x, b, c, a, lengths, checkpoints)
    runtime.require_cuda("ssm_scan", dt, x, b, c, a, *extra)
    runtime.require_contiguous("ssm_scan", dt=dt, x=x, b=b, c=c, a=a, **(
        {} if lengths is None else {"lengths": lengths}))
    bsz, s, di = dt.shape
    n = a.shape[1]
    g = _plan(n, backward=False, row_channels=bsz * di)
    f32 = dict(dtype=torch.float32, device=dt.device)
    y = torch.empty(bsz, s, di, **f32)
    h = torch.empty(bsz, di, n, **f32)
    ckpt = torch.empty(bsz, -(-s // CHUNK), di, n, **f32) \
        if checkpoints else None
    out = (y, h) if ckpt is None else (y, h, ckpt)
    if dt.numel() == 0:
        h.zero_()
        return out
    runtime.launch("ssm_scan", _kernel(), dt, dt.data_ptr(), x.data_ptr(),
                   b.data_ptr(), c.data_ptr(), a.data_ptr(),
                   None if lengths is None else lengths.data_ptr(),
                   y.data_ptr(), h.data_ptr(),
                   None if ckpt is None else ckpt.data_ptr(),
                   runtime.DTYPE_CODES[x.dtype], bsz, s, di, n, g)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0


def ssm_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                 dh: torch.Tensor, ckpt: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """``(ddt, dx, db, dc, da)`` of the selective scan from ``dy`` [B, S,
    Di] and ``dh`` [B, Di, N] (float32; ``dx`` in x's dtype), starting the
    chunks from ``ckpt`` (the forward's checkpoints): the kernel and its
    ordered reduce on CUDA tensors (without ``ckpt``, after a launch of the
    forward kernel that writes them), ``ssm_scan_bwd_plain`` on CPU
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
    nk = -(-s // CHUNK)
    if ckpt is not None and (ckpt.shape != (bsz, nk, di, n)
                             or ckpt.dtype != torch.float32):
        raise ValueError(f"ssm_scan_bwd: ckpt must be [{bsz}, {nk}, {di}, "
                         f"{n}] float32, got {tuple(ckpt.shape)} "
                         f"{ckpt.dtype}")
    ops = (dt, x, b, c, a, dy, dh) + (() if ckpt is None else (ckpt,))
    if all(t.device.type == "cpu" for t in ops):
        return ssm_scan_bwd_plain(*ops)
    runtime.require_cuda("ssm_scan_bwd", *ops)
    runtime.require_contiguous("ssm_scan_bwd", dt=dt, x=x, b=b, c=c, a=a,
                               dy=dy, dh=dh, **(
                                   {} if ckpt is None else {"ckpt": ckpt}))
    g = _plan(n, backward=True)
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty(di, n, **f32)
    if dt.numel() == 0:
        return ddt, dx, db, dc, da.zero_()
    if ckpt is None:
        ckpt = _forward(dt, x, b, c, a, None, checkpoints=True)[2]
    part_bc = torch.empty(bsz, s, -(-di // cta_channels(n)), 2 * n, **f32)
    part_a = torch.empty(bsz, di, n, **f32)
    runtime.launch("ssm_scan_bwd", _bwd_kernel(), dt,
                   *(t.data_ptr() for t in (dt, x, b, c, a, dy, dh, ckpt,
                                            part_bc, part_a, ddt, dx, db, dc,
                                            da)),
                   runtime.DTYPE_CODES[x.dtype], bsz, s, di, n, g)
    ssm_scan_bwd.launches += 1
    return ddt, dx, db, dc, da


ssm_scan_bwd.launches = 0
