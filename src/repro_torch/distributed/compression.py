"""Error-feedback int8 gradient compression for the DP all-reduce (the
reference's ``distributed/compression.py``, over per-rank tensors).

Scheme (per gradient leaf, per step):
  1. reduce-scatter the f32 gradient (each rank owns 1/n of the sum),
     divided by n: the result is the mean over ranks;
  2. add the rank's error-feedback residual, quantize the owned shard to
     int8 (one symmetric scale a shard), keep the new residual;
  3. all-gather the int8 shards and their scales and dequantize.

Wire bytes drop from ~8x size (f32 ring all-reduce) to ~4x + 1x, while
error feedback keeps the compression bias from accumulating: the residual
re-enters the next step, so the time-averaged update is unbiased.

A library, as in the reference: the train step's config has no
compression switch.  Values are lists of per-rank tensors in rank order
(``distributed.collectives``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (all_gather, axis_size,
                                                 psum_scatter)


class EFState(NamedTuple):
    """One rank's error-feedback residual of a leaf, shaped like its
    reduce-scatter shard."""

    residual: torch.Tensor


def init_ef_state(local_shard_shape: tuple[int, ...],
                  device=None) -> EFState:
    return EFState(torch.zeros(local_shard_shape, dtype=torch.float32,
                               device=device))


def _quantize_shard(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, scale): scale = max(amax, 1e-12) / 127, values
    rounded half to even and clipped to +-127.  Every division is by a
    tensor on x's device: PyTorch's CUDA kernels multiply by the
    reciprocal of a host scalar, which rounds otherwise than the host's
    (and the reference's) division."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_allreduce(gs: Sequence[torch.Tensor],
                         efs: Sequence[EFState]
                         ) -> tuple[list[torch.Tensor], list[EFState]]:
    """Mean all-reduce of the ranks' ``gs`` with an int8 wire format.

    Returns (every rank's mean gradient, the ranks' new EF states).  The
    residual has the shape of a rank's reduce-scatter shard (the padded
    flat size / n)."""
    n = axis_size(gs)
    shape, size, dtype = gs[0].shape, gs[0].numel(), gs[0].dtype
    flats = []
    for g in gs:
        flat = g.reshape(-1).float()
        pad = (-flat.numel()) % n
        flats.append(F.pad(flat, (0, pad)) if pad else flat)
    owned = [o / o.new_tensor(float(n)) + e.residual
             for o, e in zip(psum_scatter(flats), efs)]
    quant = [_quantize_shard(o) for o in owned]
    resid = [EFState(o - q.float() * s) for o, (q, s) in zip(owned, quant)]
    q_all = all_gather([q for q, _ in quant])               # int8 wire
    s_all = all_gather([s.reshape(1) for _, s in quant])    # [n]
    outs = [(q.float().reshape(n, -1) * s[:, None]).reshape(-1)[:size]
            .reshape(shape).to(dtype) for q, s in zip(q_all, s_all)]
    return outs, resid


def compressed_allreduce_tree(grads: Sequence[Mapping[str, torch.Tensor]],
                              ef_tree: Sequence[Mapping[str, EFState]]):
    """``compressed_allreduce`` leaf by leaf over the ranks' gradient
    dicts: (the ranks' mean gradient dicts, their EF state dicts)."""
    outs = [dict() for _ in grads]
    states = [dict() for _ in grads]
    for name in grads[0]:
        o, s = compressed_allreduce([g[name] for g in grads],
                                    [e[name] for e in ef_tree])
        for r in range(len(grads)):
            outs[r][name], states[r][name] = o[r], s[r]
    return outs, states


def init_ef_tree(grads_abstract: Mapping, n_devices: int,
                 device=None) -> dict[str, EFState]:
    """One rank's EF state dict matching ``compressed_allreduce``'s shard
    shapes (``grads_abstract``: name -> anything with a ``shape``)."""
    def one(leaf) -> EFState:
        flat = 1
        for d in leaf.shape:
            flat *= d
        shard = (flat + (-flat) % n_devices) // n_devices
        return init_ef_state((shard,), device)

    return {name: one(leaf) for name, leaf in grads_abstract.items()}


def wire_bytes(n_params: int, n_devices: int, compressed: bool) -> int:
    """Per-device wire traffic of one gradient sync (reporting helper)."""
    if not compressed:
        return int(2 * (n_devices - 1) / n_devices * n_params * 4)
    rs = (n_devices - 1) / n_devices * n_params * 4   # f32 reduce-scatter
    ag = (n_devices - 1) / n_devices * n_params * 1   # int8 all-gather
    return int(rs + ag)
