"""Collective schedules over per-rank tensors (the reference's
``distributed/collectives.py``), driven from one process.

The reference runs these inside ``shard_map``: each device holds its own
value and ``ppermute`` / ``psum_scatter`` / ``all_gather`` move values
between devices.  The port is single-controller as the reference is: a
value inside ``shard_map`` is here a list of per-rank tensors in rank
order, each on its rank's device, and every collective takes and returns
such a list.  Ranks may share a device (the one card, or the host).

* ``ppermute`` copies rank i's tensor to the device of rank perm(i)
  (``Tensor.to``: a peer copy across cards, differentiable, so autograd
  through a schedule built of it gives the reverse schedule).
* ``ring_reduce_scatter`` keeps the reference's schedule step for step:
  pad to a multiple of n, at step s rank i folds in chunk
  ``(i + n - 1 - s) mod n``, the partial adds in the same order, so it is
  bit for bit the reference's on the same float32 inputs.
* ``psum_scatter`` and ``all_gather`` (tiled, along dim 0) sum in rank
  order and concatenate in rank order: every rank's result of an
  all-reduce is the same bytes, and a run repeats bit for bit.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F


def axis_size(xs: Sequence) -> int:
    """Size of the mapped axis: the number of per-rank values."""
    return len(xs)


def _ring_perm(n: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """Rank i's tensor moved to the device of rank j for each (i, j) of
    ``perm``, a copy of its own; a rank that no pair sends to gets zeros
    (``lax.ppermute``)."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device, copy=True)
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def _padded_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of n, as [n, size / n]."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n, -1)


def ring_reduce_scatter(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Explicit ring reduce-scatter: [n*c] -> [c] a rank, rank i ends with
    the full sum of chunk i.

    n - 1 ``ppermute`` steps; at step s the partial held by rank i is for
    chunk (i + n - 1 - s) mod n, and the rank adds its own contribution
    to that chunk.  Each step moves 1/n of the buffer."""
    n = axis_size(xs)
    if n == 1:
        return list(xs)
    chunks = [_padded_chunks(x, n) for x in xs]
    acc = [c[(i + n - 1) % n] for i, c in enumerate(chunks)]
    for s in range(1, n):
        acc = ppermute(acc, _ring_perm(n))
        acc = [a + c[(i + n - 1 - s) % n]
               for i, (a, c) in enumerate(zip(acc, chunks))]
    return acc


def _ordered_sum(parts: Sequence[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def psum_scatter(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Reduce-scatter along dim 0 (``lax.psum_scatter(tiled=True)``): rank
    i gets the sum, in rank order, of every rank's i-th block."""
    n = axis_size(xs)
    if n == 1:
        return list(xs)
    blocks = [x.chunk(n, dim=0) for x in xs]
    return [_ordered_sum([b[i] for b in blocks], x.device)
            for i, x in enumerate(xs)]


def all_gather(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's tensor concatenated along dim 0 in rank order, on each
    rank's device (``lax.all_gather(tiled=True)``)."""
    if axis_size(xs) == 1:
        return list(xs)
    return [torch.cat([y.to(x.device) for y in xs], dim=0) for x in xs]


def ring_allreduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce as reduce-scatter + all-gather (the reference's
    decomposition): each rank's result is the same sum, in rank order."""
    n = axis_size(xs)
    if n == 1:
        return list(xs)
    shape, size = xs[0].shape, xs[0].numel()
    flats = [_padded_chunks(x, n).reshape(-1) for x in xs]
    gathered = all_gather(psum_scatter(flats))
    return [g[:size].reshape(shape) for g in gathered]
