"""Masked primitives (the reference's ``core/masking.py``): the scalar
register helpers of the register-driven engine (``core/adaptive.py``), the
lane and chunk masks of the mixed step, and the per-slot variants of
multi-topology serving.

In a fabric built at maxima shapes every lane is computed, so correctness
comes from masking: statistics (norm mean and variance, the softmax
normalizer) are taken over the live lanes only, and dead lanes are zeroed
before they can reach live ones.  Every function takes static maxima
shapes and live extents held on the device (a scalar register helper
also takes a Python int).

The scalar helpers zero a dead lane by selecting 0 (``torch.where``)
where the reference multiplies by a 0/1 mask.  On finite values the two
are the same numbers; a non-finite value in a dead lane (garbage in an
idle weight lane) is dropped here, where a product would carry the NaN.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Scalar registers: one live extent for the whole batch.
# ---------------------------------------------------------------------------
def _live(max_dim: int, live, device: torch.device) -> torch.Tensor:
    """[max_dim] bool: True for lanes < live."""
    return torch.arange(max_dim, device=device) < live


def _count(live) -> torch.Tensor | float:
    """max(live, 1) as float32: the divisor of a mean over live lanes."""
    if isinstance(live, torch.Tensor):
        return live.clamp_min(1).float()
    return float(max(int(live), 1))


def _along(mask: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A [size] mask shaped to broadcast along ``axis`` of an ndim tensor."""
    shape = [1] * ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


def dim_mask(max_dim: int, live, dtype: torch.dtype = torch.float32,
             device: torch.device | None = None) -> torch.Tensor:
    """[max_dim] mask: 1 for lanes < live, else 0 (live may be a device
    tensor, whose device the mask takes)."""
    if device is None and isinstance(live, torch.Tensor):
        device = live.device
    return _live(max_dim, live, device).to(dtype)


def masked_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, d_live,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the first ``d_live`` lanes of the last dim (Eq. 4),
    in float32; dead lanes come out 0."""
    m = _live(x.shape[-1], d_live, x.device)
    n = _count(d_live)
    x32 = torch.where(m, x.float(), 0.0)
    mu = x32.sum(-1, keepdim=True) / n
    cent = torch.where(m, x32 - mu, 0.0)
    var = cent.square().sum(-1, keepdim=True) / n
    y = cent * torch.rsqrt(var + eps)
    return torch.where(m, y * gamma.float() + beta.float(), 0.0).to(x.dtype)


def masked_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, d_live,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the first ``d_live`` lanes of the last dim."""
    m = _live(x.shape[-1], d_live, x.device)
    n = _count(d_live)
    x32 = torch.where(m, x.float(), 0.0)
    var = x32.square().sum(-1, keepdim=True) / n
    return torch.where(m, x32 * torch.rsqrt(var + eps) * gamma.float(),
                       0.0).to(x.dtype)


def masked_softmax(scores: torch.Tensor, live_len,
                   axis: int = -1) -> torch.Tensor:
    """Softmax over the first ``live_len`` entries of ``axis`` (Eq. 5 with
    the Mask() of Eq. 1), in float32; dead entries get exactly 0 weight."""
    live = _along(_live(scores.shape[axis], live_len, scores.device),
                  scores.ndim, axis)
    s = torch.where(live, scores.float(), NEG_INF)
    return torch.where(live, torch.softmax(s, dim=axis), 0.0)


def masked_mean_pool(x: torch.Tensor, seq_live) -> torch.Tensor:
    """[B, S_max, D] -> [B, D], averaging live positions only."""
    m = _live(x.shape[1], seq_live, x.device)[None, :, None]
    return (torch.where(m, x.float(), 0.0).sum(1) / _count(seq_live)) \
        .to(x.dtype)


def mask_lanes(x: torch.Tensor, live, axis: int = -1) -> torch.Tensor:
    """Zero lanes >= live along ``axis``."""
    m = _along(_live(x.shape[axis], live, x.device), x.ndim, axis)
    return torch.where(m, x, 0)


def lane_mask(num_lanes: int, n_live: torch.Tensor) -> torch.Tensor:
    """[B, W] bool: lane l of slot b is live iff l < n_live[b].

    A decoding slot uses one lane, a prefilling slot up to a chunk, an
    idle slot none; dead lanes compute garbage that is dropped at the KV
    write (routed to the null block) and at the sampling gather.
    """
    lanes = torch.arange(num_lanes, device=n_live.device)
    return lanes[None, :] < n_live[:, None]


def chunk_causal_mask(max_kv: int, start: torch.Tensor,
                      num_lanes: int) -> torch.Tensor:
    """[B, W, max_kv] bool: query lane l (cache position start[b] + l)
    sees cache positions <= start[b] + l.

    With chunk K/V written *before* the attend, this one mask covers both
    causal intra-chunk masking and the full view of the prior cache.
    """
    q_pos = start[:, None] + torch.arange(num_lanes, device=start.device)[None, :]
    kv_pos = torch.arange(max_kv, device=start.device)
    return kv_pos[None, None, :] <= q_pos[:, :, None]


# ---------------------------------------------------------------------------
# Per-slot variants: every slot of a batch may run a different topology, so
# the live extent is a [B] vector rather than one scalar register.
# ---------------------------------------------------------------------------
def slot_mask(max_dim: int, live: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, max_dim] mask: row b is 1 for lanes < live[b], else 0."""
    lanes = torch.arange(max_dim, device=live.device)
    return (lanes[None, :] < live[:, None]).to(dtype)


def masked_rmsnorm_slots(x: torch.Tensor, gamma: torch.Tensor,
                         d_live: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x [B, S, D]`` over each slot's first ``d_live[b]``
    lanes; ``gamma`` is per-slot ``[B, D]`` (gathered from a model
    table)."""
    m = slot_mask(x.shape[-1], d_live)[:, None, :]
    n = d_live.clamp_min(1).float()[:, None, None]
    x32 = x.float() * m
    var = x32.square().sum(-1, keepdim=True) / n
    y = x32 * torch.rsqrt(var + eps)
    return (y * gamma.float()[:, None, :] * m).to(x.dtype)


def masked_layernorm_slots(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, d_live: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x [B, S, D]`` with per-slot live width and per-slot
    ``[B, D]`` scale and bias."""
    m = slot_mask(x.shape[-1], d_live)[:, None, :]
    n = d_live.clamp_min(1).float()[:, None, None]
    x32 = x.float() * m
    mu = x32.sum(-1, keepdim=True) / n
    cent = (x32 - mu) * m
    var = cent.square().sum(-1, keepdim=True) / n
    y = cent * torch.rsqrt(var + eps)
    out = y * gamma.float()[:, None, :] + beta.float()[:, None, :]
    return (out * m).to(x.dtype)
