"""RG-LRU recurrent block (RecurrentGemma / Griffin) of the port.

The counterpart of the reference's ``models/rglru.py``: two input
branches (value and gate), a short temporal conv, the Real-Gated Linear
Recurrent Unit and an output projection.  The gates are block-diagonal
linears (one block per head).  ``in_x``, ``in_gate`` and ``out`` are the
port's ``Dense`` projections, so they route through ``apply_dense`` (the
matmul kernels under ``"pallas"``, int8 weights under ``quant="int8"``).

The dtype flow is the reference's: the branches, the conv and the
block-diagonal gate products in x's dtype, the gates and the recurrence
in float32 (``sqrt(max(1 - a^2, 1e-6))`` as the input normalization), the
gate branch through GELU with tanh, and the conv state stored in bf16.

The recurrence of a prefill (``rglru_prefill``, ``rglru_forward``) is one
``kernels/rglru_scan.py`` call, the hand-written kernel on a CUDA tensor
(the reference's ``lax.scan``).  ``rglru_prefill`` takes ``lengths`` ([B]
int32, on the device): a row's positions from its length on keep h, and
its conv state is the rows ``length - 3 .. length - 1`` of the value
branch, so a prompt right-padded up to its bucket leaves the state of its
last real token (the reference's engine pads the prompt and scans over the
pad; the port does not copy that).  Decode is the reference's one-step
elementwise update, written into the state in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan as scan_mod
from repro_torch.models.layers import apply_dense

# Griffin fixes c = 8 in a_t = a^(c * softplus(param) * r_t)
_C = 8.0
CONV_K = 4


class LRUState(NamedTuple):
    conv: torch.Tensor  # [B, CONV_K - 1, width] bf16
    h: torch.Tensor     # [B, width] recurrent state (float32)


def width(cfg) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _block_diag(x: torch.Tensor, w_blocks: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x [..., w] through the block-diagonal weight [nh, blk, blk], in x's
    dtype."""
    nh, blk, _ = w_blocks.shape
    xs = x.reshape(*x.shape[:-1], nh, blk)
    y = torch.einsum("...hi,hij->...hj", xs, w_blocks.to(x.dtype))
    return y.reshape(x.shape) + bias.to(x.dtype)


def _gates(x_conv: torch.Tensor, p) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_t, gated input) of the recurrence, in float32."""
    r = torch.sigmoid(_block_diag(x_conv, p.gate_a_w, p.gate_a_b).float())
    i = torch.sigmoid(_block_diag(x_conv, p.gate_in_w, p.gate_in_b).float())
    log_a = -_C * F.softplus(p.a_param.float()) * r
    a = torch.exp(log_a)
    # input normalization sqrt(1 - a^2) keeps the state variance bounded
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, i * x_conv.float() * mult


def _conv(window: torch.Tensor, p, dtype: torch.dtype) -> torch.Tensor:
    """The temporal conv over ``window`` [..., CONV_K, w] (oldest row
    first): sum_k window[k] * conv_w[CONV_K - 1 - k], summed in float32
    and rounded once to ``dtype``, then the bias in ``dtype``."""
    taps = p.conv_w.to(dtype).flip(0)
    y = (window.float() * taps.float()).sum(-2)
    return y.to(dtype) + p.conv_b.to(dtype)


def _conv_full(xi: torch.Tensor, p) -> torch.Tensor:
    """The conv at every position of xi [B, S, w], zeros before 0."""
    s = xi.shape[1]
    xp = F.pad(xi, (0, 0, CONV_K - 1, 0))
    window = torch.stack([xp[:, i:i + s] for i in range(CONV_K)], dim=-2)
    return _conv(window, p, xi.dtype)


def _branches(x: torch.Tensor, p, mm: str):
    """(value branch xi, GELU-tanh gate branch) of x."""
    xi = apply_dense(x, p.in_x, mm)
    gate = F.gelu(apply_dense(x, p.in_gate, mm), approximate="tanh")
    return xi, gate


def rglru_prefill(x: torch.Tensor, p, cfg, mm: str,
                  lengths: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, LRUState]:
    """Full-sequence block x [B, S, d] -> (out [B, S, d], the decode state
    after each row's last real position: ``lengths`` [B] int32, or S)."""
    b_, s, _ = x.shape
    xi, gate = _branches(x, p, mm)
    a, gated = _gates(_conv_full(xi, p), p)
    hs, h = scan_mod.rglru_scan(a.contiguous(), gated.contiguous(), lengths)
    out = apply_dense(hs.to(x.dtype) * gate, p.out, mm)
    n = torch.full((b_,), s, dtype=torch.int32, device=x.device) \
        if lengths is None else lengths
    # the last CONV_K - 1 value rows before each row's length, zeros
    # before position 0
    pos = n[:, None].long() - (CONV_K - 1) + torch.arange(
        CONV_K - 1, device=x.device)[None, :]
    rows = xi.gather(1, pos.clamp(min=0)[..., None].expand(
        b_, CONV_K - 1, xi.shape[-1]))
    conv = torch.where((pos >= 0)[..., None], rows, 0).to(torch.bfloat16)
    return out, LRUState(conv, h)


def rglru_forward(x: torch.Tensor, p, cfg, mm: str) -> torch.Tensor:
    """Full-sequence recurrent block.  x: [B, S, d]."""
    return rglru_prefill(x, p, cfg, mm)[0]


def rglru_init_state(cfg, batch: int, device, lead: tuple[int, ...] = ()
                     ) -> LRUState:
    """Zeroed state, with ``lead`` dims in front (the cache's layer stack)."""
    w = width(cfg)
    return LRUState(
        torch.zeros(*lead, batch, CONV_K - 1, w, dtype=torch.bfloat16,
                    device=device),
        torch.zeros(*lead, batch, w, dtype=torch.float32, device=device))


def rglru_decode(x: torch.Tensor, p, cfg, state: LRUState,
                 mm: str) -> torch.Tensor:
    """One-token decode x [B, 1, d] -> out [B, 1, d]; the conv window and
    h advance in ``state`` in place."""
    xi, gate = _branches(x, p, mm)
    window = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    a, gated = _gates(_conv(window, p, x.dtype), p)
    h = a * state.h + gated
    out = apply_dense(h.to(x.dtype)[:, None] * gate, p.out, mm)
    state.conv.copy_(window[:, 1:])
    state.h.copy_(h)
    return out
