"""Lane and chunk masks of the fused mixed step (the reference's
``core/masking.py`` ``lane_mask`` / ``chunk_causal_mask``)."""
from __future__ import annotations

import torch


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
