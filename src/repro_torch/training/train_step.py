"""The train step: loss -> grads -> AdamW (the reference's
``training/train_step.py``), on one device or on a mesh.

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
the remat recomputation reads them too.

``make_train_step(..., mesh=...)`` is the sharded step, driven from one
process as the reference's single controller drives its mesh (no
``torch.distributed``): the state lives on the mesh as
``distributed.sharding.Sharded`` leaves (``state_shardings``, placed by
``sharding.place``), each data-parallel replica takes its rows of the
batch (``batch_shardings``) and computes its loss and gradients, the
replicas' gradients are averaged with ``collectives.ring_allreduce``, and
every rank runs AdamW on its shards with the clip scale of the whole
gradient's norm.  ``abstract_state`` waits for item 17b.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.spec import _not_ported
from repro_torch.distributed import collectives, sharding
from repro_torch.models.model import Model, combine_loss
from repro_torch.models.tensor_parallel import TPModel
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


def state_shardings(model: Model, mesh: sharding.Mesh,
                    strategy: sharding.ShardingStrategy) -> TrainState:
    """Each leaf's ``NamedSharding`` on ``mesh``: the parameters by
    ``param_rules`` (a heads dimension in whole heads), the moments as
    their parameter (split with it under fsdp: ZeRO), the step count
    replicated."""
    p_sh = sharding.tree_param_shardings(
        mesh, model.axes(), dict(model.named_parameters()), strategy,
        head_dim=model.cfg.resolved_head_dim)
    return TrainState(p_sh, AdamWState(step=sharding.replicated(mesh),
                                       m=p_sh, v=p_sh))


def batch_shardings(mesh: sharding.Mesh,
                    strategy: sharding.ShardingStrategy,
                    batch_abstract: dict) -> dict:
    """The batch's rows over the data-parallel axes, whole over the rest
    (``batch_abstract``: name -> anything with a ``shape``)."""
    return {k: sharding.batch_sharding(mesh, strategy, ndim=len(v.shape))
            for k, v in batch_abstract.items()}


def make_train_step(model: Model, cfg: TrainStepConfig, mesh=None,
                    strategy: sharding.ShardingStrategy | None = None,
                    batch_abstract: dict | None = None):
    """The step on one device (``mesh=None``: ``make_step_fn``), or the
    sharded step on ``mesh`` (a ``distributed.sharding.Mesh`` with its
    devices): then (step, state_shardings, batch_shardings), as the
    reference's.  ``strategy`` defaults to ``strategy_for_mesh(mesh)``,
    ``batch_abstract`` to 2-D ``tokens`` and ``targets``.

    The sharded step takes a state placed on the mesh
    (``sharding.place(state, state_shardings)``) and a batch of tensors
    or of ``Sharded`` leaves (a tensor is placed by ``batch_shardings``).
    Each data-parallel replica computes its rows' loss and gradients:
    with tp = 1 the model itself bound to the replica's parameters (one
    ``Model`` per distinct device), with tp > 1 ``TPModel.loss`` over the
    replica's tp ranks (the dense family; others name item 16e).  A
    leaf whole across the tp ranks takes the rank-order sum of its
    copies' gradients.  The replicas' gradients are averaged with
    ``collectives.ring_allreduce`` in a fixed order; the MoE balance term,
    not linear in the batch, averages the replicas' (f, p) before the
    product, so the loss is the one device's.  Under ``strategy.fsdp``
    every leaf split over the data axes (its "embed" dimension) is
    ``all_gather``-ed before the forward and its gradient comes back
    through ``ring_reduce_scatter``; its moments stay split with it.  The
    clip takes the norm of the whole logical gradient (each element
    once), then every rank runs ``adamw_update`` on its shards.
    ``strategy.sp`` only moves activations under the reference's GSPMD:
    it is accepted and changes nothing here.  The metrics (on the first
    rank's device) are ``loss`` and the aux terms (means over replicas),
    ``lr`` and ``grad_norm``.  At a (1, 1) mesh the step computes what
    the one device's does, bit for bit."""
    if mesh is None:
        return make_step_fn(model, cfg)
    if not isinstance(mesh, sharding.Mesh) or not mesh.devices:
        raise ValueError("make_train_step(mesh=...) takes a "
                         "distributed.sharding.Mesh with its devices "
                         f"(launch.mesh.make_dev_mesh), not {mesh!r}")
    if not model.trainable:
        raise ValueError(f"{model.cfg.name}: the model was built for "
                         "serving; build it with Model(..., trainable=True)")
    strategy = strategy or sharding.strategy_for_mesh(mesh)
    if batch_abstract is None:
        batch_abstract = {"tokens": torch.empty(0, 0, device="meta"),
                          "targets": torch.empty(0, 0, device="meta")}
    st_sh = state_shardings(model, mesh, strategy)
    b_sh = batch_shardings(mesh, strategy, batch_abstract)
    return _ShardedStep(model, cfg, mesh, strategy, st_sh, b_sh), st_sh, b_sh


class _ShardedStep:
    """The sharded step (``make_train_step``): (state, batch) ->
    (state, metrics)."""

    def __init__(self, model: Model, cfg: TrainStepConfig,
                 mesh: sharding.Mesh, strategy: sharding.ShardingStrategy,
                 st_sh: TrainState, b_sh: dict):
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.b_sh, self.specs = b_sh, {n: sh.spec
                                       for n, sh in st_sh.params.items()}
        names = mesh.axis_names
        self.tp_axis = strategy.tp_axis if strategy.tp_axis in names \
            else None
        self.dp_axes = tuple(a for a in strategy.dp_axes if a in names)
        self.tp = mesh.shape[self.tp_axis] if self.tp_axis else 1
        self.devices = [torch.device(d) for d in mesh.devices]
        # the replicas' tp groups, in data-parallel order, and the groups
        # of one tp position across the replicas
        self.replicas = sharding.axis_groups(mesh, self.tp_axis) \
            if self.tp_axis else [[r] for r in range(mesh.size)]
        self.dp_groups = sharding.axis_groups(mesh, self.dp_axes) \
            if self.dp_axes else [[r] for r in range(mesh.size)]
        self.dp = len(self.replicas)
        # per leaf: its dim split over the data axes (fsdp), whether the tp
        # axis splits it, the ranks whose blocks tile it once
        self.fsdp_dim = {n: sharding.dim_of(spec, self.dp_axes)
                         for n, spec in self.specs.items()}
        self.tp_split = {n: sharding.dim_of(spec, self.tp_axis) is not None
                         for n, spec in self.specs.items()}
        self.owners = {n: sharding.owners(mesh, spec)
                       for n, spec in self.specs.items()}
        self.nets = [self._net(group) for group in self.replicas]

    def _net(self, group: list[int]):
        """What computes a replica's loss: the model (a meta copy moved to
        the replica's device where the model lives elsewhere) or, with
        tp > 1, a trainable ``TPModel`` over the group's devices."""
        m = self.model
        devs = [self.devices[r] for r in group]
        if self.tp > 1:
            if m.remat != "none":
                raise _not_ported(f"remat={m.remat!r} under tensor "
                                  "parallelism", "item 16e")
            return TPModel(m.cfg, devs, param_dtype=m.param_dtype,
                           compute_dtype=m.compute_dtype, trainable=True)
        if devs[0] == m.device:
            return m
        net = Model(m.cfg, param_dtype=m.param_dtype,
                    compute_dtype=m.compute_dtype, device="meta",
                    trainable=True, remat=m.remat)
        net.device = devs[0]
        return net

    @contextlib.contextmanager
    def _bound(self, i: int, leaves: list[dict]):
        """Replica i's net with its ranks' tensors bound."""
        net, group = self.nets[i], self.replicas[i]
        with contextlib.ExitStack() as stack:
            if self.tp > 1:
                for container, r in zip(net.ranks, group):
                    stack.enter_context(bound(container, leaves[r]))
            else:
                stack.enter_context(bound(net, leaves[group[0]]))
            yield net

    def _leaves(self, params: dict) -> list[dict]:
        """Each rank's tensors for the forward: its shard, or under fsdp
        its tp block gathered over the data axes (a new leaf)."""
        out = [dict() for _ in self.devices]
        for n, x in params.items():
            dim = self.fsdp_dim[n]
            if dim is None:
                for r, t in enumerate(x.shards):
                    out[r][n] = t
                continue
            for group in self.dp_groups:
                whole = collectives.all_gather(
                    [x.shards[r].detach().movedim(dim, 0) for r in group])
                for r, t in zip(group, whole):
                    out[r][n] = t.movedim(0, dim).requires_grad_(True)
        return out

    def _grads(self, leaves: list[dict], batches: list[dict]
               ) -> tuple[list[dict], torch.Tensor, dict]:
        """The replicas' loss terms on their rows (each replica's forward
        first: the MoE balance term averages every replica's (f, p)),
        then each replica's backward: (each rank's gradients by name, the
        mean loss, the mean aux terms)."""
        terms = []
        for i in range(self.dp):
            with self._bound(i, leaves) as net:
                terms.append(net.loss_terms(batches[i]))
        if "balance" in terms[0]:
            f = _mean([t["balance"][0].detach() for t in terms])
            for t in terms:
                t["balance"] = (f.to(t["balance"][1].device),
                                t["balance"][1])
        grads = [dict() for _ in self.devices]
        losses, auxes = [], []
        for i, group in enumerate(self.replicas):
            total, aux = combine_loss(terms[i], self.model.cfg)
            names = [(r, n) for r in group for n in leaves[r]]
            with self._bound(i, leaves):
                got = torch.autograd.grad(
                    total, [leaves[r][n] for r, n in names],
                    allow_unused=True)
            for (r, n), g in zip(names, got):
                grads[r][n] = torch.zeros_like(leaves[r][n]) if g is None \
                    else g
            losses.append(total.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        return grads, _mean(losses), {k: _mean([a[k] for a in auxes])
                                      for k in auxes[0]}

    def _combine(self, grads: list[dict]) -> list[dict]:
        """The logical gradient's shards on every rank: a leaf whole across
        the tp ranks takes the rank-order sum of its copies' gradients;
        then the mean over the replicas (``ring_allreduce``, or under
        fsdp ``ring_reduce_scatter`` back to the rank's block)."""
        for n in self.specs:
            if self.tp > 1 and not self.tp_split[n]:
                for group in self.replicas:
                    g = _ordered_sum([grads[r][n] for r in group])
                    for k, r in enumerate(group):
                        grads[r][n] = g if k == 0 else g.to(
                            self.devices[r], copy=True)
            if self.dp == 1:
                continue
            dim = self.fsdp_dim[n]
            for group in self.dp_groups:
                parts = [grads[r][n] for r in group]
                if dim is None:
                    out = collectives.ring_allreduce(parts)
                else:
                    moved = [p.movedim(dim, 0) for p in parts]
                    shape = (moved[0].shape[0] // self.dp,
                             *moved[0].shape[1:])
                    out = [c.reshape(shape).movedim(0, dim) for c in
                           collectives.ring_reduce_scatter(moved)]
                for r, g in zip(group, out):
                    grads[r][n] = g / self.dp
        return grads

    def _norm(self, grads: list[dict], names: list[str]) -> torch.Tensor:
        """The global norm of the logical gradient, each element once:
        every leaf's norm from the blocks of its owners, then the norm of
        those in the order of ``names`` (``optimizer.global_norm`` where a
        leaf is one block)."""
        mine = {r: [n for n in names if r in self.owners[n]]
                for r in range(len(self.devices))}
        norms = {}
        for r, ns in mine.items():
            if ns:
                got = torch._foreach_norm([grads[r][n].float() for n in ns])
                for n, v in zip(ns, got):
                    norms.setdefault(n, []).append(v)
        dev = self.devices[0]
        per_leaf = [norms[n][0].to(dev) if len(norms[n]) == 1
                    else torch.linalg.vector_norm(torch.stack(
                        [v.to(dev) for v in norms[n]])) for n in names]
        return torch.linalg.vector_norm(torch.stack(per_leaf))

    def _rows(self, batch: dict) -> list[dict]:
        """Each replica's rows of the batch, on its first rank's device."""
        placed = {k: v if isinstance(v, sharding.Sharded)
                  else sharding.place_leaf(v, self.b_sh[k])
                  for k, v in batch.items()}
        return [{k: v.shards[group[0]] for k, v in placed.items()}
                for group in self.replicas]

    def _loss_and_grads(self, state: TrainState, batch: dict
                        ) -> tuple[torch.Tensor, dict, list[dict]]:
        """(loss, aux, each rank's shards of the logical gradient)."""
        cfg = self.cfg
        if not isinstance(state.opt.step, sharding.Sharded):
            raise TypeError("the sharded step takes a state placed on its "
                            "mesh: sharding.place(state, state_shardings)")
        leaves = self._leaves(state.params)
        rows = self._rows(batch)
        if cfg.accum_steps > 1:
            n = next(iter(rows[0].values())).shape[0]
            if n % cfg.accum_steps:
                raise ValueError(f"a replica's {n} rows do not split into "
                                 f"accum_steps={cfg.accum_steps} "
                                 "microbatches")
            micro = [[dict(zip(b, parts)) for parts in zip(
                *(t.chunk(cfg.accum_steps) for t in b.values()))]
                for b in rows]
            grads = [{n: torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device)
                      for n, t in lv.items()} for lv in leaves]
            losses = []
            for j in range(cfg.accum_steps):
                g, loss, _ = self._grads(leaves, [m[j] for m in micro])
                for acc, gr in zip(grads, g):
                    for name, a in acc.items():
                        a.add_(gr[name] / cfg.accum_steps)
                losses.append(loss)
            loss = torch.stack(losses).mean()
            aux = {"xent": loss}
        else:
            grads, loss, aux = self._grads(leaves, rows)
        return loss, aux, self._combine(grads)

    def loss_and_grads(self, state: TrainState, batch: dict
                       ) -> tuple[torch.Tensor, dict, dict]:
        """(loss, aux, the logical gradient as ``Sharded`` leaves under
        the parameters' shardings) of the step, before the clip: what
        ``sharding.assemble`` holds against one device's
        ``loss_and_grads``."""
        loss, aux, grads = self._loss_and_grads(state, batch)
        return loss, aux, {n: sharding.Sharded(
            [g[n] for g in grads], state.params[n].sharding,
            state.params[n].shape) for n in self.specs}

    def __call__(self, state: TrainState, batch: dict):
        if not self.cfg.donate:
            state = _copy_sharded(state)
        loss, aux, grads = self._loss_and_grads(state, batch)
        opt, names = state.opt, list(state.params)
        norm = self._norm(grads, names)
        metrics = None
        for r, dev in enumerate(self.devices):
            _, _, om = adamw_update(
                {n: state.params[n].shards[r] for n in names},
                {n: grads[r][n] for n in names},
                AdamWState(opt.step.shards[r],
                           {n: opt.m[n].shards[r] for n in names},
                           {n: opt.v[n].shards[r] for n in names}),
                self.cfg.optimizer, grad_norm=norm.to(dev))
            metrics = metrics or om
        return state, {"loss": loss, **aux, **metrics}


def _ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def _mean(parts: list[torch.Tensor]) -> torch.Tensor:
    """The rank-order mean of per-replica values, on the first one's
    device (the value itself for one)."""
    if len(parts) == 1:
        return parts[0]
    return _ordered_sum(parts) / len(parts)


def _copy_sharded(state: TrainState) -> TrainState:
    def copy(x: sharding.Sharded) -> sharding.Sharded:
        return sharding.Sharded(
            [t.detach().clone().requires_grad_(t.requires_grad)
             for t in x.shards], x.sharding, x.shape)
    opt = state.opt
    return TrainState({n: copy(x) for n, x in state.params.items()},
                      AdamWState(copy(opt.step),
                                 {n: copy(x) for n, x in opt.m.items()},
                                 {n: copy(x) for n, x in opt.v.items()}))
