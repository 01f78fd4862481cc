"""Microbatched pipeline parallelism (GPipe) over per-rank tensors (the
reference's ``distributed/pipeline.py``), driven from one process.

Stages are the ranks of a mesh axis; the layer-stacked parameters are
cut along their leading axis, stage s's slice on stage s's device.  The
schedule runs ``n_micro + n_stages - 1`` ticks in order: every tick each
stage applies its layer to the activation it holds, then the activations
shift one stage to the right (a copy to the next stage's device) while
the next microbatch enters stage 0.  The last stage's outputs then go
around the ring, so every rank returns them.  The bubble fraction is the
classic (S - 1) / (T + S - 1).

A stage whose slot of a tick holds no microbatch (the fill and drain
bubbles) computes nothing here: the reference computes it on values no
output reads, so the outputs and their gradients are the same.

Every shift is a ``Tensor.to`` copy (``collectives.ppermute``'s move),
which is differentiable, so autograd through ``pipeline_forward`` is the
reverse-schedule backward pass: no reverse schedule is written by hand.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    raise TypeError(f"stage parameters hold tensors, dicts, lists and "
                    f"tuples, not {type(tree)}")


def pipeline_forward(stage_fn: Callable, stage_params: Sequence[Any],
                     xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The pipelined apply over the stages' values.

    stage_params: stage s's weights (a tree of tensors on its device),
    in stage order.  xs: every stage's copy of the microbatched input
    [n_micro, mb, ...] (stage 0's is the one read).  Returns every
    stage's copy of the last stage's outputs [n_micro, mb, ...]."""
    n_stages = len(stage_params)
    n_micro = xs[0].shape[0]
    held: list[torch.Tensor | None] = [None] * n_stages
    emitted: list[torch.Tensor] = []
    for t in range(n_micro + n_stages - 1):
        outs: list[torch.Tensor | None] = [None] * n_stages
        for s in range(n_stages):
            if not 0 <= t - s < n_micro:       # a bubble: nothing held
                continue
            inp = xs[0][t] if s == 0 else held[s]
            outs[s] = stage_fn(stage_params[s], inp)
        if outs[-1] is not None:               # microbatch t - (S - 1)
            emitted.append(outs[-1])
        # shift right: stage s's output to stage s + 1's device
        held = [None] + [None if o is None else o.to(xs[s + 1].device)
                         for s, o in enumerate(outs[:-1])]
    # replicate around the ring, one shift at a time: last -> stage 0 ->
    # stage 1 -> ...
    copies = [torch.stack(emitted)]
    for s in range(n_stages - 1):
        copies.append(copies[-1].to(xs[s].device))
    return copies[1:] + copies[:1]


def make_pipelined_apply(stage_fn: Callable, mesh, *,
                         axis_name: str = "stage") -> Callable:
    """Wrap ``stage_fn(stage_params, x) -> x`` into a mesh-level pipelined
    apply: f(stacked_params [S, ...], x [n_micro, mb, ...]) -> outputs,
    on the first stage's device.  ``mesh`` is a
    ``distributed.sharding.Mesh`` whose ``axis_name`` has S ranks (one
    device each, in order; other axes must be 1)."""
    if mesh.size != mesh.shape.get(axis_name):
        raise ValueError(f"the pipeline runs on a mesh of the one axis "
                         f"{axis_name!r}; got {dict(mesh.axes)}")
    devices = [torch.device(d) for d in mesh.devices]

    def apply(stacked_params, x: torch.Tensor) -> torch.Tensor:
        n = len(devices)
        stages = [_tree_map(lambda p, s=s: p.select(0, s).to(devices[s]),
                            stacked_params) for s in range(n)]
        xs = [x.to(d) for d in devices]
        return pipeline_forward(stage_fn, stages, xs)[0]

    return apply


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule (reported by the launcher)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
