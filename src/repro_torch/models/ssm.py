"""Mamba-1 selective SSM block (falcon-mamba-7b) of the port.

The counterpart of the reference's ``models/ssm.py``: ``in_proj`` into a
value branch and a gate branch, a causal depthwise conv over time, the
selective parameters (``x_proj`` into dt, B and C, ``dt_proj`` with its
bias and softplus), the selective scan, the D skip, the SiLU gate and
``out_proj``.  The four projections are the port's ``Dense`` ones, so
they route through ``apply_dense`` (the matmul kernels under
``"pallas"``, int8 weights under ``quant="int8"``).

The dtype flow is the reference's: the branches and the conv in x's
dtype, the selective parameters and the scan in float32, the gate and
the skip in float32 rounded once to x's dtype before ``out_proj``, and
the conv state stored in bf16 even at float32 compute.

The recurrence of a prefill (``ssm_prefill``, ``ssm_forward``) is one
``kernels/ssm_scan.py`` call, the hand-written kernel on a CUDA tensor
(the reference's ``lax.scan``, over ``a_bar`` and ``bx`` that it
materializes and the kernel does not).  ``ssm_prefill`` takes ``lengths``
([B] int32, on the device): a row's positions from its length on keep h,
and its conv state is the value branch's rows ``length - K + 1 .. length
- 1`` (zeros before position 0), gathered at static shapes, so a prompt
right-padded up to its bucket leaves the state of its last real token
(the reference's engine pads the prompt, scans over the pad and takes its
conv tail from the padded row; the port does not copy that).  Decode is
the reference's one-step elementwise update, written into the state in
place, with the scan's readout order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.models.layers import apply_dense


class SSMState(NamedTuple):
    """Decode-time recurrent state (with ``lead`` dims in front, the
    cache's layer stack)."""

    conv: torch.Tensor  # [B, K - 1, d_inner] trailing conv window (bf16)
    h: torch.Tensor     # [B, d_inner, d_state] SSM state (float32)


def dims(cfg) -> tuple[int, int, int]:
    """(d_inner, dt_rank, d_state)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, s.state_dim


def _conv(rows: list[torch.Tensor], p, dtype: torch.dtype) -> torch.Tensor:
    """The depthwise conv over ``rows``, the window's K rows [..., d_inner]
    oldest first: sum_k rows[k] * conv_w[K - 1 - k], summed in order in
    float32 and rounded once to ``dtype``, then the bias in ``dtype`` and
    SiLU."""
    taps = p.conv_w.to(dtype).flip(0).float()
    y = rows[0].float() * taps[0]
    for k in range(1, len(rows)):
        y = y + rows[k].float() * taps[k]
    return F.silu(y.to(dtype) + p.conv_b.to(dtype))


def _inputs(x_conv: torch.Tensor, p, cfg, mm: str):
    """x_conv [..., d_inner] -> (dt, B, C) selective parameters, float32."""
    _, dt_rank, n = dims(cfg)
    proj = apply_dense(x_conv, p.x_proj, mm)
    dt = F.softplus(apply_dense(proj[..., :dt_rank], p.dt_proj, mm).float())
    b_mat = proj[..., dt_rank:dt_rank + n].float()
    c_mat = proj[..., dt_rank + n:].float()
    return dt, b_mat, c_mat


def _out(y: torch.Tensor, x_conv: torch.Tensor, z: torch.Tensor, p,
         dtype: torch.dtype, mm: str) -> torch.Tensor:
    """The D skip and the SiLU gate in float32, rounded to ``dtype``, then
    ``out_proj``."""
    y = y + x_conv.float() * p.d_skip.float()
    y = (y * F.silu(z.float())).to(dtype)
    return apply_dense(y, p.out_proj, mm)


def ssm_prefill(x: torch.Tensor, p, cfg, mm: str,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence block x [B, S, d] -> (out [B, S, d], the decode state
    after each row's last real position: ``lengths`` [B] int32, or S)."""
    b_, s, _ = x.shape
    d_inner, _, _ = dims(cfg)
    k = cfg.ssm.conv_kernel
    xz = apply_dense(x, p.in_proj, mm)
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xp = F.pad(xi, (0, 0, k - 1, 0))
    x_conv = _conv([xp[:, i:i + s] for i in range(k)], p, x.dtype)
    dt, b_mat, c_mat = _inputs(x_conv, p, cfg, mm)
    a = -torch.exp(p.a_log.float())
    # at float32 compute b and c are views of proj
    y, h = scan_mod.ssm_scan(dt, x_conv, b_mat.contiguous(),
                             c_mat.contiguous(), a, lengths)
    out = _out(y, x_conv, z, p, x.dtype, mm)
    n = torch.full((b_,), s, dtype=torch.int32, device=x.device) \
        if lengths is None else lengths
    # the last K - 1 value rows before each row's length, zeros before
    # position 0
    pos = n[:, None].long() - (k - 1) + torch.arange(
        k - 1, device=x.device)[None, :]
    rows = xi.gather(1, pos.clamp(min=0)[..., None].expand(
        b_, k - 1, d_inner))
    conv = torch.where((pos >= 0)[..., None], rows, 0).to(torch.bfloat16)
    return out, SSMState(conv, h)


def ssm_forward(x: torch.Tensor, p, cfg, mm: str) -> torch.Tensor:
    """Full-sequence mamba block.  x: [B, S, d] -> [B, S, d]."""
    return ssm_prefill(x, p, cfg, mm)[0]


def ssm_init_state(cfg, batch: int, device, lead: tuple[int, ...] = ()
                   ) -> SSMState:
    """Zeroed state, with ``lead`` dims in front (the cache's layer stack)."""
    d_inner, _, n = dims(cfg)
    return SSMState(
        torch.zeros(*lead, batch, cfg.ssm.conv_kernel - 1, d_inner,
                    dtype=torch.bfloat16, device=device),
        torch.zeros(*lead, batch, d_inner, n, dtype=torch.float32,
                    device=device))


def ssm_decode(x: torch.Tensor, p, cfg, state: SSMState,
               mm: str) -> torch.Tensor:
    """One-token decode x [B, 1, d] -> out [B, 1, d]; the conv window and
    h advance in ``state`` in place (the scan's operators for one
    position)."""
    d_inner, _, _ = dims(cfg)
    xz = apply_dense(x[:, 0], p.in_proj, mm)
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    window = torch.cat([state.conv.to(xi.dtype), xi[:, None]], dim=1)
    x_conv = _conv(window.unbind(1), p, x.dtype)
    dt, b_mat, c_mat = _inputs(x_conv, p, cfg, mm)
    a = -torch.exp(p.a_log.float())
    d = dt[..., None]
    h = torch.exp(d * a) * state.h + (d * b_mat[:, None, :]) \
        * x_conv.float()[..., None]
    y = scan_mod.readout(h, c_mat[:, None, :])
    out = _out(y, x_conv, z, p, x.dtype, mm)[:, None]
    state.conv.copy_(window[:, 1:])
    state.h.copy_(h)
    return out
