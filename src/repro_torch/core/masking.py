"""Masked primitives of the fused steps (the reference's
``core/masking.py``): the lane and chunk masks of the mixed step, and the
per-slot variants of multi-topology serving.

In a fabric built at maxima shapes every lane is computed, so correctness
comes from masking: statistics (norm mean and variance) are taken over each
slot's live lanes only, and dead lanes are zeroed before they can reach
live ones.  Every function takes static maxima shapes and live extents
held on the device.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


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
