"""Logical-axis sharding rules -> per-leaf mesh specs (DP/TP/EP/SP/FSDP).

The port's copy of the reference's ``distributed/sharding.py``, with no
JAX: a spec is a tuple of mesh-axis names (or None, or a tuple of names)
per dimension, trailing Nones dropped (``()`` is replicated), and a mesh
is its axis sizes plus a device list (``Mesh``).  The models name every
parameter's axes logically (``Model.axes()``: "embed", "heads", "ffn",
"vocab", ...); ``param_rules`` maps those names to mesh axes under a
``ShardingStrategy`` and ``resolve_spec`` resolves each leaf with the
reference's two rules: a dimension that does not divide its mesh extent
falls back to a whole copy, and a mesh axis is used by one dimension at
most.  ``kv_cache_shardings`` does the same for a decode cache (the
kv-head axis of K and V, the trailing kv-head axis of an int8 pool's
scale rows).

The reference hands these specs to GSPMD, which partitions the jitted
step and inserts its collectives.  The port is explicit and driven from
one process, as the reference's single controller drives its mesh: a
sharded tensor is a ``Sharded`` leaf, every rank's block of one logical
tensor (``local_shard``) on that rank's device.  ``tree_param_shardings``
gives each parameter its ``NamedSharding`` (a heads dimension counted in
whole heads, so a rank never holds part of a head), ``place`` cuts a
tree onto a mesh (``jax.device_put`` with NamedShardings) and
``assemble`` joins it back (``jax.device_get``); ``axis_groups`` lists
the ranks a collective over some mesh axes runs across.  The reference's
``active`` / ``constrain`` (GSPMD's in-graph activation hints) have no
counterpart: ``activation_rules`` stays as the table of where the
activations live.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import torch

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, and the devices in row-major
    order over them (empty for an abstract mesh, which only resolves
    specs)."""

    axes: tuple[tuple[str, int], ...]
    devices: tuple = ()

    def __post_init__(self) -> None:
        n = 1
        for _, size in self.axes:
            n *= size
        if self.devices and len(self.devices) != n:
            raise ValueError(f"a mesh of {dict(self.axes)} takes {n} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n

    def coords(self, index: int) -> dict[str, int]:
        """The axis coordinates of device ``index`` (row-major)."""
        out = {}
        for name, size in reversed(self.axes):
            out[name] = index % size
            index //= size
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: Spec = ()


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    """Which parallelism features are active and on which mesh axes."""

    dp_axes: tuple[str, ...] = ("data",)   # batch / gradient all-reduce
    tp_axis: str | None = "model"          # tensor parallel (heads/ffn/vocab)
    fsdp: bool = False                     # shard 'embed' of params over dp
    sp: bool = False                       # sequence-parallel activations
    ep_axis: str | None = None             # experts; defaults to tp_axis

    @property
    def expert_axis(self) -> str | None:
        return self.ep_axis or self.tp_axis


def strategy_for_mesh(mesh: Mesh, **kw) -> ShardingStrategy:
    """Default strategy: every non-'model' mesh axis is data-parallel."""
    dp = tuple(a for a in mesh.axis_names if a != "model")
    tp = "model" if "model" in mesh.axis_names else None
    return ShardingStrategy(dp_axes=dp, tp_axis=tp, **kw)


def param_rules(s: ShardingStrategy) -> dict[str, Any]:
    """Logical axis name -> mesh axes of a parameter; unlisted names are
    replicated."""
    tp = s.tp_axis
    return {
        "vocab": tp, "heads": tp, "kv_heads": tp, "ffn": tp,
        "experts": s.expert_axis, "dinner": tp, "lru": tp,
        "embed": s.dp_axes if s.fsdp else None,
        "q_lora": None, "kv_lora": None,
        "layers": None, "pos": None, "state": None,
    }


def activation_rules(s: ShardingStrategy) -> dict[str, Any]:
    """Where the activations live: the batch over the dp axes; with
    Megatron-SP the residual stream's tokens over the tp axis."""
    return {
        "batch": s.dp_axes,
        "seq": s.tp_axis if s.sp else None,
        "heads": s.tp_axis, "kv_heads": s.tp_axis, "ffn": s.tp_axis,
        "experts": s.expert_axis, "embed": None, "vocab": s.tp_axis,
        "dinner": s.tp_axis, "lru": s.tp_axis,
    }


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def resolve_spec(logical: tuple, shape: tuple[int, ...], rules: dict,
                 mesh: Mesh) -> Spec:
    """Translate a logical spec to mesh axes with the divisibility
    fallback; a mesh axis already used by an earlier dim is dropped."""
    out: list = []
    used: set[str] = set()
    names = tuple(logical) + (None,) * (len(shape) - len(logical))
    for dim, name in enumerate(names):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple
                         if a in mesh.shape and a not in used)
        if not ax_tuple or shape[dim] % _axis_size(mesh, ax_tuple) != 0:
            out.append(None)
            continue
        used.update(ax_tuple)
        out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tp_mesh(devices) -> Mesh:
    """A ``(data=1, model=len(devices))`` mesh over an explicit device
    list: one serving replica's tensor-parallel group (the replica set's
    data parallelism lives on the host, ``serving.cluster``)."""
    devs = tuple(devices)
    if not devs:
        raise ValueError("tp_mesh needs at least one device")
    return Mesh((("data", 1), ("model", len(devs))), devs)


def kv_cache_shardings(mesh: Mesh, cache, strategy: ShardingStrategy):
    """Shardings for a decode cache, mirroring ``param_rules``' kv_heads
    rule with the same per-leaf divisibility fallback.

    A KV cache is recognized structurally (a NamedTuple whose first two
    fields are ``k`` / ``v``): the value leaves ``[L, rows, cols, n_kv,
    hd]`` shard the kv-head axis (-2) over the tp axis, int8 scale rows
    (the values' shape without hd) their trailing kv-head axis, and every
    other leaf (MLA latents, recurrent state) is replicated.  A kv-head
    count that does not divide the tp extent replicates that leaf."""
    tp = strategy.tp_axis
    tp_n = mesh.shape.get(tp, 1) if tp is not None else 1
    rep = NamedSharding(mesh)

    def axis_spec(leaf, axis: int) -> NamedSharding:
        nd = len(leaf.shape)
        if tp_n > 1 and nd > axis % nd and leaf.shape[axis] % tp_n == 0:
            return NamedSharding(mesh, (None,) * (axis % nd) + (tp,))
        return rep

    def walk(node):
        if node is None:
            return None
        fields = getattr(node, "_fields", None)
        if fields is not None and fields[:2] == ("k", "v"):
            return type(node)(
                axis_spec(node.k, -2), axis_spec(node.v, -2),
                *(None if s is None else axis_spec(s, -1)
                  for s in node[2:]))
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return type(node)(*out) if fields is not None \
                else type(node)(out)
        return rep

    return walk(cache)


def batch_sharding(mesh: Mesh, strategy: ShardingStrategy,
                   ndim: int = 2) -> NamedSharding:
    """Tokens / targets [B, S, ...]: the batch over the dp axes."""
    dp = tuple(a for a in strategy.dp_axes if a in mesh.shape)
    spec = [dp if dp else None] + [None] * (ndim - 1)
    while spec and spec[-1] is None:
        spec.pop()
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh)


def _shards(mesh: Mesh, spec: Spec) -> int:
    n = 1
    for axes in spec:
        if axes is not None:
            n *= _axis_size(mesh, axes)
    return n


def per_device_bytes(tree: Mapping, mesh: Mesh,
                     shardings: Mapping) -> int:
    """Static estimate of per-device bytes of a flat tree (name -> a
    tensor or anything with ``shape`` and a torch ``dtype``) under its
    shardings (name -> ``NamedSharding``)."""
    total = 0
    for name, leaf in tree.items():
        n = 1
        for d in leaf.shape:
            n *= d
        size = leaf.dtype.itemsize
        total += n * size // max(_shards(mesh, shardings[name].spec), 1)
    return total


def local_shard(t, spec: Spec, mesh: Mesh, index: int):
    """Device ``index``'s block of ``t`` under ``spec``: each sharded
    dimension is cut into equal blocks, block ``i`` the device's
    coordinate on the dimension's axes (row-major over a tuple of axes).
    A view where ``t`` is a tensor."""
    coords = mesh.coords(index)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        n, block = 1, 0
        for a in names:
            block = block * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        size = t.shape[dim] // n
        t = t.narrow(dim, block * size, size)
    return t


def shard_shape(shape: tuple[int, ...], spec: Spec,
                mesh: Mesh) -> tuple[int, ...]:
    """The shape of one device's block of a leaf of ``shape``."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            out[dim] //= _axis_size(mesh, axes)
    return tuple(out)


def whole_heads(names: tuple, shape: tuple[int, ...],
                head_dim: int | None) -> tuple[int, ...]:
    """``shape`` with a "heads" / "kv_heads" dimension counted in heads of
    ``head_dim`` (unchanged without one): what ``resolve_spec`` divides
    so that a rank holds whole heads."""
    if head_dim is None:
        return tuple(shape)
    return tuple(d // head_dim if n in ("heads", "kv_heads") else d
                 for d, n in zip(shape, tuple(names)
                                 + (None,) * (len(shape) - len(names))))


def tree_param_shardings(mesh: Mesh, axes_tree: Mapping,
                         abstract_tree: Mapping,
                         strategy: ShardingStrategy,
                         head_dim: int | None = None
                         ) -> dict[str, NamedSharding]:
    """A ``NamedSharding`` per parameter (name -> its logical axes, name ->
    anything with a ``shape``) under ``param_rules``; with ``head_dim`` a
    heads dimension is divided in whole heads (the tensor-parallel
    step's rule, ``models.tensor_parallel``)."""
    rules = param_rules(strategy)
    return {name: NamedSharding(mesh, resolve_spec(
        axes_tree[name], whole_heads(axes_tree[name], tuple(leaf.shape),
                                     head_dim), rules, mesh))
        for name, leaf in abstract_tree.items()}


def axis_groups(mesh: Mesh, axes) -> list[list[int]]:
    """The ranks a collective over ``axes`` (a name or a tuple of names)
    runs across: one group for each coordinate of the other axes, each
    group and the groups in rank order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    groups: dict[tuple, list[int]] = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        key = tuple(c[a] for a in mesh.axis_names if a not in names)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def _names(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def dim_of(spec: Spec, axes) -> int | None:
    """The dimension ``spec`` splits over any of ``axes`` (a mesh axis
    serves one dimension at most), or None."""
    want = set(_names(axes))
    return next((d for d, a in enumerate(spec) if want & set(_names(a))),
                None)


def owners(mesh: Mesh, spec: Spec) -> list[int]:
    """The ranks whose blocks under ``spec`` tile the whole tensor once:
    coordinate 0 on every axis the spec does not use."""
    used = {a for entry in spec for a in _names(entry)}
    return [r for r in range(mesh.size)
            if all(v == 0 for a, v in mesh.coords(r).items()
                   if a not in used)]


class Sharded:
    """One logical tensor on a mesh: ``shards[r]`` is rank r's block under
    ``sharding`` (``local_shard``), on the rank's device, its own storage
    (a whole copy on every rank where the spec does not split it)."""

    def __init__(self, shards: list[torch.Tensor], sharding: NamedSharding,
                 shape: tuple[int, ...]):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> Spec:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def requires_grad(self) -> bool:
        return self.shards[0].requires_grad

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={dict(self.mesh.axes)})")


def place_leaf(t: torch.Tensor, sh: NamedSharding,
               dtype: torch.dtype | None = None,
               requires_grad: bool | None = None) -> Sharded:
    """``t`` cut onto ``sh``'s mesh: each rank's block copied to its
    device (in ``dtype``, t's by default), ``requires_grad`` as t's
    unless given."""
    mesh = sh.mesh
    if not mesh.devices:
        raise ValueError("placing a tensor needs a mesh with devices")
    grad = t.requires_grad if requires_grad is None else requires_grad
    shards = []
    with torch.no_grad():
        for r, dev in enumerate(mesh.devices):
            block = local_shard(t, sh.spec, mesh, r)
            out = torch.empty(block.shape, dtype=dtype or t.dtype,
                              device=dev)
            shards.append(out.copy_(block).requires_grad_(grad))
    return Sharded(shards, sh, tuple(t.shape))


def place(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` (a dict or NamedTuple of those, nested, or
    a tensor) placed under its ``NamedSharding`` in ``shardings`` (the
    same structure): the counterpart of ``jax.device_put(tree,
    shardings)``."""
    if isinstance(tree, torch.Tensor):
        return place_leaf(tree, shardings)
    if isinstance(tree, Sharded):
        return place_leaf(assemble_leaf(tree), shardings)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(a, b) for a, b in zip(tree, shardings)))
    return {k: place(v, shardings[k]) for k, v in tree.items()}


def assemble_leaf(x: Sharded, device=None) -> torch.Tensor:
    """The whole tensor from the blocks of the ranks in ``owners`` (on
    ``device``, the first rank's by default), detached."""
    device = x.shards[0].device if device is None else device
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    with torch.no_grad():
        for r in owners(x.mesh, x.spec):
            local_shard(out, x.spec, x.mesh, r).copy_(x.shards[r])
    return out


def assemble(tree: Any, device=None) -> Any:
    """Every ``Sharded`` leaf of ``tree`` joined into its whole tensor
    (``jax.device_get``); tensors pass through."""
    if isinstance(tree, Sharded):
        return assemble_leaf(tree, device)
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(assemble(v, device) for v in tree))
    return {k: assemble(v, device) for k, v in tree.items()}
