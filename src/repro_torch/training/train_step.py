"""The train step of one device: loss -> grads -> AdamW (the reference's
``training/train_step.py`` without its mesh).

Mixed precision as the reference: f32 master parameters (a trainable
``Model``), the compute dtype inside the model.  Per-layer remat is the
model's ``remat``.  With ``accum_steps > 1`` the batch's leading dim
splits into microbatches whose gradients, each divided by
``accum_steps``, are summed in float32 in order, as the reference's
``lax.scan``.  ``donate=True`` updates the state's parameters and
moments in place (the counterpart of donated buffers); ``donate=False``
returns a new state and leaves the one passed in intact.  The step runs
eagerly and reads nothing back to the host: its metrics are device
scalars.

A state's ``params`` are a dict of tensors by the model's parameter
names: ``init_state`` hands out the model's own parameters, and the
step binds whatever tensors the state holds (a restored checkpoint's, a
``donate=False`` step's) to the model for the loss and its backward, so
the remat recomputation reads them too.  The sharded step
(``make_train_step(..., mesh=...)``, ROADMAP.md Queue 1 item 16c),
``abstract_state`` and the sharding helpers (items 16c and 17b) are not
ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.spec import _not_ported
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    accum_steps: int = 1          # microbatch gradient accumulation
    donate: bool = True


def init_state(model: Model, generator: torch.Generator,
               opt_cfg: AdamWConfig) -> TrainState:
    """Draw the model's weights from ``generator`` (``Model.init``) and
    zero its moments; the state's params are the model's parameters."""
    if not model.trainable:
        raise ValueError(f"{model.cfg.name}: the model was built for "
                         "serving; build it with Model(..., trainable=True)")
    model.init(generator)
    params = dict(model.named_parameters())
    return TrainState(params, adamw_init(params, opt_cfg))


@contextlib.contextmanager
def bound(model: Model, params: dict[str, torch.Tensor]):
    """The model's parameters replaced by the tensors of ``params`` (by
    name) inside the block, its own put back after."""
    swapped = []
    for name, t in params.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path)
        swapped.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, own in swapped:
            mod._parameters[leaf] = own


def loss_and_grads(model: Model, params: dict[str, torch.Tensor],
                   batch: dict) -> tuple[torch.Tensor, dict, dict]:
    """(loss, aux, grads) of ``model.loss`` at ``params``; the backward
    runs inside the binding, so a remat layer recomputes from them.  A
    parameter the loss does not reach gets zeros."""
    with bound(model, params):
        loss, aux = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _copy(state: TrainState) -> TrainState:
    params = {n: p.detach().clone().requires_grad_(p.requires_grad)
              for n, p in state.params.items()}
    opt = state.opt
    return TrainState(params, AdamWState(
        opt.step.clone(), {n: t.clone() for n, t in opt.m.items()},
        {n: t.clone() for n, t in opt.v.items()}))


def make_step_fn(model: Model, cfg: TrainStepConfig):
    """The step: (state, batch) -> (state, metrics).  Metrics are
    ``loss``, the loss's aux terms (with accumulation ``xent`` alone, the
    microbatches' mean, as the reference), ``lr`` and ``grad_norm``."""

    def step(state: TrainState, batch: dict):
        if not cfg.donate:
            state = _copy(state)
        if cfg.accum_steps > 1:
            n = next(iter(batch.values())).shape[0]
            if n % cfg.accum_steps:
                raise ValueError(f"a batch of {n} rows does not split into "
                                 f"accum_steps={cfg.accum_steps} microbatches")
            micro = [dict(zip(batch, parts)) for parts in zip(
                *(t.chunk(cfg.accum_steps) for t in batch.values()))]
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in state.params.items()}
            losses = []
            for mb in micro:
                loss, _, g = loss_and_grads(model, state.params, mb)
                for name, acc in grads.items():
                    acc.add_(g[name] / cfg.accum_steps)
                losses.append(loss)
            loss = torch.stack(losses).mean()
            aux = {"xent": loss}
        else:
            loss, aux, grads = loss_and_grads(model, state.params, batch)
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       cfg.optimizer)
        return TrainState(params, opt), {"loss": loss, **aux, **om}

    return step


def make_train_step(model: Model, cfg: TrainStepConfig, mesh=None):
    """The step on one device; a mesh (the reference's sharded step) is
    refused."""
    if mesh is not None:
        raise _not_ported("the sharded train step (mesh=...)", "item 16c")
    return make_step_fn(model, cfg)
